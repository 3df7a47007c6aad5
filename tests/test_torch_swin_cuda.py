"""The windowed attention and the Swin encoder on the card.

* ``ops/window_attention`` at the encoder's first-stage shapes (343
  windows of 343 tokens, 3 heads of 16; shifted and not) runs the
  memory-efficient SDPA kernel (``fmha_cutlass*`` in the profiler's
  trace), never the math path (``math_calls`` stays 0), counts the mask it
  materialises, and agrees with a float64 witness of the same formula:
  the output and the gradients of qkv and of the bias within 3 % (bf16) /
  1e-3 (fp32) of each tensor's largest magnitude (bf16 rounds q, k, v, the
  bias and the probabilities to 8 bits: a few parts in a thousand, summed
  over 343 keys).
* The published-width encoder's training forward and backward captured in
  a CUDA graph replays the eager result: the same features, and
  gradients within 1e-3 of each tensor's largest magnitude (the bias
  table's gradient adds with atomics, in no fixed order); a replay adds
  no host call to the counters.

Skips without a card; imports no JAX:
``python -m pytest tests/test_torch_swin_cuda.py -m cuda --noconftest``.
"""

import pytest
import torch

from mmnn_sts_torch.models import swin
from mmnn_sts_torch.ops import window_attention


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the fused SDPA kernels run only "
                    "there)")
    torch.backends.cuda.matmul.allow_tf32 = False


def witness(qkv, bias, mask, heads):
    """softmax(q kᵀ / sqrt(d) + bias [+ mask]) v in float64."""
    b, w, n, c3 = qkv.shape
    d = c3 // 3 // heads
    q, k, v = qkv.double().view(b, w, n, 3, heads, d).permute(
        3, 0, 1, 4, 2, 5)
    s = q @ k.transpose(-1, -2) * d ** -0.5 + bias.double()
    if mask is not None:
        s = s + mask[..., :n].double().unsqueeze(1)
    return (torch.softmax(s, -1) @ v).transpose(2, 3).reshape(
        b, w, n, c3 // 3)


def close(got, want, tol, what):
    err = float((got.double() - want).abs().max())
    scale = float(want.abs().max())
    assert err <= tol * scale, (what, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_window_attention_runs_the_efficient_kernel(dtype, shifted):
    g = torch.Generator(device="cuda").manual_seed(0)
    b, w, n, heads, c = 2, 343, 343, 3, 48
    qkv = torch.randn((b, w, n, 3 * c), generator=g, device="cuda")
    qkv = qkv.to(dtype).requires_grad_()
    bias = (0.5 * torch.randn((heads, n, n), generator=g, device="cuda")
            ).requires_grad_()
    mask = None
    if shifted:
        plain = swin.shift_mask((49, 49, 49), (7, 7, 7), (3, 3, 3), "cuda")
        mask = window_attention.padded_mask(plain, dtype)
    before = dict(window_attention.counts)
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = window_attention.window_attention(qkv, bias, mask, heads)
        grad = torch.randn(out.shape, generator=g, device="cuda")
        out.backward(grad.to(dtype))
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()}
    assert any("fmha_cutlassF" in k for k in names), sorted(names)
    assert any("fmha_cutlassB" in k for k in names), sorted(names)
    assert not any("fprop" in k.lower() for k in names)
    assert window_attention.counts["math_calls"] == before["math_calls"]
    size = torch.finfo(dtype).bits // 8
    expect = heads * n * 352 * (w if shifted else 1) * size
    assert window_attention.counts["mask_bytes"] - before["mask_bytes"] \
        == expect
    x = qkv.detach().double().requires_grad_()
    bb = bias.detach().double().requires_grad_()
    want = witness(x, bb, mask, heads)
    want.backward(grad.double())
    tol = 3e-2 if dtype == torch.bfloat16 else 1e-3
    close(out, want, tol, "out")
    close(qkv.grad, x.grad, tol, "dqkv")
    close(bias.grad, bb.grad, tol, "dbias")


@pytest.mark.cuda
def test_cuda_encoder_captures_in_a_graph():
    torch.manual_seed(0)
    # no dropout: the replay draws other numbers than the eager step
    model = swin.SwinViT(in_channels=2, out_channels=None, dropout_prob=0.0,
                         dtype=torch.bfloat16).cuda()
    x = torch.randn((2, 64, 64, 64, 2), device="cuda")

    def step():
        model.zero_grad(set_to_none=False)
        feats = model(x, return_features=True)
        feats.float().square().sum().backward()
        return feats

    model.zero_grad(set_to_none=False)
    eager = step().detach().clone()
    eager_grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        feats = step()
    before = dict(window_attention.counts)
    graph.replay()
    torch.cuda.synchronize()
    assert window_attention.counts == before
    close(feats, eager.double(), 1e-3, "features")
    for k, p in model.named_parameters():
        close(p.grad, eager_grads[k].double(), 1e-3, k)
