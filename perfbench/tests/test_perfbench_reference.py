"""The plain reference against the program on the CPU at a small size,
and its control against the limits."""

import ast
import re
import time

import pytest
import torch

from perfbench import check
from perfbench.cells import resolve
from perfbench.reference import augment as ref_aug
from perfbench.reference import train as ref_train
from perfbench.tests.conftest import REPO, write_tiny_root


def test_reference_agrees_with_the_program(tiny_root):
    """Both in float32 on the CPU: the gaps are rounding's, which the
    followed supersteps grow from about 1e-7 at the first (train-mode
    BatchNorm carries a rounding forward from step to step)."""
    from perfbench.training import run_program

    cell = resolve("tiny.mix", tiny_root)
    device = torch.device("cpu")
    run = run_program(cell, 2 ** 40 + 7, 0.0, False, device,
                      time.perf_counter())
    ref = check.reference_side(cell, run, device)
    prog = check.program_side(run, ref["weights"])
    c = check.readings(prog, ref)
    gaps = [abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                 ref["losses"])]
    assert len(gaps) == 8  # two epochs of 3 full supersteps and a tail
    assert max(gaps[:3]) < 1e-4
    assert c["loss_gap"] < 1e-3
    assert c["grad_gap_median"] < 1e-3
    assert c["update_gap_median"] < 5e-3
    assert c["pred_gap"] < 1e-2
    assert c["val_gap"] < 1e-2


def test_augmentation_draws_and_voxels_match_the_program():
    from mmnn_sts_torch.ops import augment

    vols = torch.rand(4, 12, 12, 10, 2) * 900 + 1
    g1 = torch.Generator().manual_seed(11)
    g2 = torch.Generator().manual_seed(11)
    ours = ref_aug.draw(4, (12, 12, 10, 2), g1, "cpu")
    theirs = augment.draw_augment_params(4, g2, "cpu", (12, 12, 10, 2))
    assert set(ours) == set(theirs)
    for k in ours:
        assert torch.equal(ours[k], theirs[k]), k
    # every op on, to reach each one's arithmetic
    for k in ours:
        if k.startswith("apply_"):
            ours[k] = torch.ones_like(ours[k])
    ours["theta"] = torch.tensor([0.3, 2.0, -7.5, 14.0])
    ours["flip_axis"] = torch.tensor([0, 1, 2, 3])
    ours["zoom"] = torch.tensor([0.93, 1.0, 1.07, 1.1])
    got = ref_aug.augment(vols, ours)
    want = augment.apply_train_augment(vols, dict(ours))
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4)


def test_cox_loss_matches_the_program():
    from mmnn_sts_torch.ops.cox import column_losses

    g = torch.Generator().manual_seed(3)
    h = torch.randn(16, 2, generator=g)
    ev = (torch.rand(16, 2, generator=g) < 0.7).float()
    dur = torch.randint(1, 6, (16, 2), generator=g).float()
    mask = (torch.arange(16) < 13).float()
    for m in (None, mask):
        assert torch.allclose(ref_train.cox_loss(h, ev, dur, m),
                              column_losses(h, ev, dur, mask=m), atol=1e-6)


def test_onecycle_matches_the_program():
    from mmnn_sts_torch.train.schedule import onecycle

    sched = onecycle(5e-4, 8, 100)
    # the program computes the rate in float32, the reference in float64
    for step in (0, 1, 2, 3, 100, 239, 240, 500, 799, 800, 900):
        assert ref_train.onecycle_rate(step, 5e-4, 8, 100) == \
            pytest.approx(sched(step), rel=1e-5)


@pytest.mark.parametrize("n", [480, 200, 512])
def test_epoch_order_and_pad_match_the_program(n):
    from mmnn_sts_torch.data.loader import EpochBatcher

    batcher = EpochBatcher(n, 8, 8, seed=2 ** 33 + 5, two_level=True)
    for epoch in (0, 1):
        assert (ref_train.epoch_order(2 ** 33 + 5, n, 8, 8, epoch)
                == batcher.epoch_indices(epoch)).all()
    assert (ref_train.pad_mask(n, 8, 8) == batcher.pad_mask()).all()


def test_reference_imports_nothing_of_the_program():
    """Every file under ``reference/``, the families in ``kinds/`` and the
    tests' own family included: torch, numpy, math and the reference's own
    modules alone."""
    paths = [*(REPO / "perfbench" / "reference").rglob("*.py"),
             *(REPO / "perfbench" / "tests" / "family").glob("*.py")]
    assert any(p.parent.name == "kinds" for p in paths)
    for path in paths:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                assert name.split(".")[0] in (
                    "torch", "numpy", "math", "__future__") or (
                    name.startswith("perfbench.reference")), (path, name)


def test_no_kind_is_named_outside_its_family():
    """The harness and the shared reference modules name no model kind:
    each family lives in ``reference/kinds/<kind>.py`` alone, found by the
    configuration's ``model.kind``."""
    kinds = [p.stem for p in
             (REPO / "perfbench" / "reference" / "kinds").glob("*.py")]
    assert "densenet_blend" in kinds
    shared = [*(REPO / "perfbench").glob("*.py"),
              *(REPO / "perfbench" / "reference").glob("*.py")]
    assert len(shared) > 10
    for path in shared:
        text = path.read_text()
        for kind in kinds:
            assert not re.search(rf"\b{kind}\b", text), (path, kind)


def test_fp8_control_fails_the_limits(tmp_path):
    """The bfloat16 cell's control, the reference computed in float8, at
    a test size of the cell's own model family: some number over the
    cell's limit."""
    from perfbench.training import run_program

    name = write_tiny_root(tmp_path, "dn121_mmnn.train_fused_bf16")
    cell = resolve(name, tmp_path)
    device = torch.device("cpu")
    run = run_program(cell, 21, 0.0, False, device, time.perf_counter())
    ref = check.reference_side(cell, run, device)
    control = check.readings(
        check.reference_side(cell, run, device, "fp8"), ref)
    assert any(control[k] > v["limit"] for k, v in cell.limits.items()), \
        control


def test_bf16_program_fails_the_fp32_limits(tmp_path):
    """The float32 cell's control is the program's own bfloat16 path."""
    name = write_tiny_root(tmp_path, "dn121_mmnn.train_fused_fp32",
                           dtype="bfloat16")
    from perfbench import run as bench

    result = bench.measure(resolve(name, tmp_path), 21, 0.0, False,
                           torch.device("cpu"), time.perf_counter())
    assert result["correct"] is False, result["checks"]
