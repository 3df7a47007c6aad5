"""The port's serving slice as a whole, held against the JAX package's.

One small multimodal blend model (TinyDenseNet at 16^3 x 2ch + the clinical
MLP) with numpy-drawn BN statistics is saved by the JAX package's own
save_params_npz. The JAX side serves it through its StableHLO export and
ServingModel; the port side turns the same .npz into its servable with
``python -m mmnn_sts_torch.infer.export`` (called in process) and serves it
with ModelServer on the CPU, on an ephemeral port. A raw (un-normalised)
request must get the same predictions from both. Tolerance rtol/atol 1e-4.
"""

import io
import json
import os
import subprocess
import sys
import urllib.error
import urllib.request
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmnn_sts_tpu.config import Config as JaxConfig
from mmnn_sts_tpu.infer.export import ServingModel as JaxServingModel
from mmnn_sts_tpu.infer.export import export_forward as jax_export_forward
from mmnn_sts_tpu.models import build_model as jax_build_model
from mmnn_sts_tpu.train.checkpoint import save_params_npz
from mmnn_sts_torch.infer import export as port_export
from mmnn_sts_torch.infer.server import ModelServer
from test_torch_convert import jax_flat, jax_variables, randomise

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_serving")
    cfg = JaxConfig()
    cfg.image_model.name = "tinydensenet"
    cfg.image_model.spatial_size = [16, 16, 16]
    model = jax_build_model(cfg, images=True, preop=True, postop=False,
                            blend=True)
    sample = {"image": jnp.zeros((2, 16, 16, 16, 2), jnp.float32),
              "clinical": jnp.zeros((2, 11), jnp.float32)}
    flat = randomise(jax_flat(model.init(jax.random.key(0), sample)), seed=11)
    variables = jax_variables(flat)
    state = SimpleNamespace(params=variables["params"],
                            batch_stats=variables["batch_stats"],
                            apply_fn=model.apply)
    jax_serve = JaxServingModel(jax_export_forward(
        state, sample, blend=True, preprocess=True, platforms=("cpu",)))

    weights = str(tmp / "best_surv_model.npz")
    save_params_npz(weights, variables["params"], variables["batch_stats"])
    config = tmp / "config.yaml"
    config.write_text("ImageModel:\n  name: tinydensenet\n"
                      "  spatial_size: [16, 16, 16]\n")
    artifact = str(tmp / "model.pt")
    assert port_export.main([
        "--config", str(config), "--weights", weights, "--images", "--preop",
        "--blend", "--out", artifact, "--device", "cpu",
    ]) == 0
    srv = ModelServer(artifact, host="127.0.0.1", port=0, device="cpu")
    srv.start_background()
    yield srv, artifact, jax_serve
    srv.shutdown()


def _batch(n, seed):
    rng = np.random.default_rng(seed)
    # raw MRI-like intensities: eval_transform must run inside the servable
    return {"image": (rng.normal(size=(n, 16, 16, 16, 2)) ** 2 * 500
                      ).astype(np.float32),
            "clinical": rng.normal(size=(n, 11)).astype(np.float32)}


def _post(srv, body: bytes, ctype: str, path="/invocations"):
    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}",
                                 data=body, headers={"Content-Type": ctype})
    return urllib.request.urlopen(req, timeout=60)


def _npz(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def test_npz_request_matches_jax_serving(served):
    """Batch 3 pads to bucket 4 on both sides; the 3 answers agree."""
    srv, _, jax_serve = served
    batch = _batch(3, seed=0)
    with _post(srv, _npz(**batch), "application/x-npz") as r:
        assert r.status == 200
        assert r.headers["Content-Type"] == "application/x-npz"
        with np.load(io.BytesIO(r.read())) as data:
            got = data["predictions"]
    want = jax_serve({k: jnp.asarray(v) for k, v in batch.items()})
    assert got.shape == (3, 2) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, **TOL)


def test_json_request_matches_serving_model(served):
    srv, artifact, _ = served
    batch = _batch(1, seed=1)
    body = json.dumps({"inputs": {k: v.tolist() for k, v in batch.items()}})
    with _post(srv, body.encode(), "application/json") as r:
        got = np.asarray(json.loads(r.read())["predictions"])
    want = port_export.ServingModel(artifact, device="cpu")(batch)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_ping(served):
    srv, _, _ = served
    with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/ping",
                                timeout=60) as r:
        assert r.status == 200


@pytest.mark.parametrize("body,ctype", [
    (b"not json", "application/json"),
    (b"not an npz", "application/x-npz"),
    (_npz(image=np.zeros((2, 16, 16, 16, 2), np.float32),
          clinical=np.zeros((2, 7), np.float32)), "application/x-npz"),
    (_npz(clinical=np.zeros((2, 11), np.float32)), "application/x-npz"),
], ids=["bad-json", "bad-npz", "wrong-width", "missing-modality"])
def test_bad_requests_are_400(served, body, ctype):
    srv, _, _ = served
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(srv, body, ctype)
    assert ei.value.code == 400
    assert "error" in json.loads(ei.value.read())


def test_unknown_path_is_404(served):
    srv, _, _ = served
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/nope", timeout=60)
    assert ei.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(srv, b"{}", "application/json", path="/nope")
    assert ei.value.code == 404


def test_model_fault_is_500(served):
    srv, _, _ = served
    orig = srv.model

    class Boom:
        def __call__(self, inputs):
            raise RuntimeError("CUDA error: an illegal memory access")

    srv.model = Boom()
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv, _npz(**_batch(1, seed=2)), "application/x-npz")
        assert ei.value.code == 500
    finally:
        srv.model = orig


def test_default_device_raises_without_cuda(served, monkeypatch):
    """Entry points default to the card and never fall back to the CPU."""
    _, artifact, _ = served
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_export.ServingModel(artifact)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelServer(artifact, host="127.0.0.1", port=0)


def test_port_runs_without_jax(served):
    """Importing the server and running one CPU forward, then a forward of
    each new model family without a bottleneck (tinycnn, seresnet50,
    r3d_18), loads neither jax nor the JAX package (a subprocess: this
    pytest process imports jax)."""
    _, artifact, _ = served
    script = (
        "import sys, numpy as np\n"
        "from mmnn_sts_torch.infer.server import ModelServer\n"
        "from mmnn_sts_torch.infer.export import ServingModel\n"
        f"m = ServingModel({artifact!r}, device='cpu')\n"
        "rng = np.random.default_rng(0)\n"
        "out = m({'image': rng.random((2, 16, 16, 16, 2), np.float32),\n"
        "         'clinical': rng.random((2, 11), np.float32)})\n"
        "assert out.shape == (2, 2) and np.isfinite(out).all(), out\n"
        "import torch\n"
        "from mmnn_sts_torch.config import Config\n"
        "from mmnn_sts_torch.models import build_model\n"
        "for name in ('tinycnn', 'seresnet50', 'r3d_18'):\n"
        "    cfg = Config()\n"
        "    cfg.image_model.name = name\n"
        "    with torch.no_grad():\n"
        "        out = build_model(cfg, True, False, False, False).eval()(\n"
        "            torch.from_numpy(rng.random((1, 16, 16, 16, 2),\n"
        "                                        np.float32)))\n"
        "    assert out.shape == (1, 2) and torch.isfinite(out).all(), name\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'flax')\n"
        "             or k.startswith('mmnn_sts_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {**os.environ, "PYTHONPATH": REPO}
    res = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
