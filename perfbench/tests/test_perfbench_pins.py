"""The DenseNet families, pinned bit for bit to what the harness gave
before each family's reference moved into a file of its own
(``reference/kinds/densenet*.py``): the weight spec (names, shapes,
order) and the operation counts of both configuration files, and the tiny
cell's seeded weights and reference readings (float32 on the CPU, two
threads: ``conftest``)."""

import hashlib
import json
import types

import pytest
import torch

from perfbench import check, counts, inputs
from perfbench.cells import resolve
from perfbench.reference.common import weight_spec
from perfbench.tests.conftest import config_cell

SEED = 2 ** 40 + 7


def spec_digest(spec) -> str:
    return hashlib.sha256(json.dumps(
        [[name, list(shape)] for name, shape in spec]).encode()).hexdigest()


@pytest.mark.parametrize("config,digest,entries,elements,train,forward", [
    ("dn121_mmnn",
     "0dd1ba78c1cead7477b2d4259d9bdcfec66b57140558073f1d56ac95d37eca10",
     648, 11_362_262, 33_614_806_016.0, 12_164_033_088.0),
    ("dn264_3d",
     "032eef0cb0fe821e244306569536ff35209a2e79a457110f977e83be605403c6",
     1326, 40_671_746, 40_028_896_768.0, 14_302_063_104.0),
])
def test_spec_and_counts_of_the_configurations(config, digest, entries,
                                               elements, train, forward):
    cell = config_cell(config)
    spec = weight_spec(cell.family(), cell.config["model"])
    assert len(spec) == entries
    assert sum(torch.Size(s).numel() for _, s in spec) == elements
    assert spec_digest(spec) == digest
    assert counts.train_flops(cell) == train
    assert counts.forward_flops(cell) == forward


def test_tiny_cells_seeded_weights(tiny_root):
    cell = resolve("tiny.mix", tiny_root)
    assert spec_digest(weight_spec(cell.family(), cell.config["model"])) == \
        "1481a9f4863af729a81094149a671dc05b2e80df18e8c07d1d28a45cc5a6b92e"
    weights = inputs.make_weights(cell, inputs.split_seed(SEED)["weights"],
                                  torch.device("cpu"))
    h = hashlib.sha256()
    for name, w in weights.items():
        h.update(name.encode())
        h.update(w.contiguous().numpy().tobytes())
    assert h.hexdigest() == \
        "64193752b060d14313ff994b64e50db714bf983d2c63018c4a52ef81fb4b094a"


def test_tiny_cells_reference_readings(tiny_root):
    """The reference side alone, on the seed's cohort: every followed
    superstep's loss and the validation predictions, bit for bit."""
    cell = resolve("tiny.mix", tiny_root)
    seeds = inputs.split_seed(SEED)
    device = torch.device("cpu")
    run = types.SimpleNamespace(
        seeds=seeds, cohort=inputs.make_cohort(cell, seeds["cohort"], device),
        steps_per_epoch=4, followed_epochs=2, checked_steps=3)
    ref = check.reference_side(cell, run, device)
    assert ref["losses"] == [
        22.775041818618774, 22.8925302028656, 24.284034490585327,
        3.386314868927002, 23.40860891342163, 23.285226821899414,
        23.79982352256775, 2.9975385665893555]
    val = ref["val_preds"].contiguous()
    assert list(val.shape) == [3, 16, 2]
    assert val.flatten()[:4].tolist() == [
        -0.5580834746360779, 0.46372395753860474, -0.47520214319229126,
        0.5182096362113953]
    assert hashlib.sha256(val.numpy().tobytes()).hexdigest() == \
        "63938a60a06b04e8e1208773544a65ce5032fc4180ae2763fd3cfb7fc2c75bee"
