"""The per-layer readers on a recorded synthetic profile."""

import json
import types

import pytest

from perfbench import counts, kernels
from perfbench.cells import resolve
from perfbench.tests.conftest import REPO
from perfbench.trace import Trace

BF16 = "dn121_mmnn.train_fused_bf16"


def trace_of(device, host=(), start=0.0, end=1.0):
    return Trace(start, end, list(device), list(host))


def test_busy_is_the_union_not_the_sum():
    t = trace_of([("k1", 0.1, 0.3), ("k2", 0.2, 0.4), ("copy", 0.25, 0.35),
                  ("k3", 0.6, 0.7)])
    assert t.busy_s() == pytest.approx(0.4)
    assert sum(e - s for _, s, e in t.device) == pytest.approx(0.6)
    assert t.gaps() == pytest.approx([(0.0, 0.1), (0.4, 0.6), (0.7, 1.0)])


def test_idle_share_reader():
    cell = resolve(BF16, REPO)
    run = types.SimpleNamespace(trace=trace_of(
        [("a", 0.0, 0.5), ("b", 0.25, 0.75)]))
    assert cell.reader("device_idle_share")(run, cell) == pytest.approx(25.0)
    run.trace = None
    assert cell.reader("device_idle_share")(run, cell) is None


def test_gaps_by_host_activity():
    t = trace_of([("k", 0.0, 0.2), ("k", 0.2 + 10e-6, 0.5), ("k", 0.9, 1.0)],
                 host=[("aten::item", 0.45, 0.95),
                       ("cudaStreamSynchronize", 0.5, 0.6)])
    b = t.breakdown()
    gaps = dict(b["idle_gaps"])
    assert gaps["host in aten::item"] == pytest.approx(0.4)
    assert gaps["gaps under 50 us between device operations"] == \
        pytest.approx(10e-6)
    assert b["device_ops"][0] == ["k", pytest.approx(1.0 - 0.4 - 10e-6)]


def profiled(cell):
    p = {"supersteps": 8, "accum": 8, "micro_batch": 8, "val_volumes": 96,
         "train_volumes": 480}
    model = cell.config["model"]
    calls = (8 * 8 * counts.bottleneck_calls(model, (64,) * 3, 8)
             + counts.bottleneck_calls(model, (64,) * 3, 96))
    return p, calls


@pytest.mark.parametrize("cell_name,metric,kernel", [
    (BF16, "fused_fwd_roofline.bf16",
     "void fused_bn_relu_matmul_bf16_kernel<128>(CUtensorMap)"),
    ("dn121_mmnn.train_fused_fp32", "fused_fwd_roofline.fp32",
     "void fused_bn_relu_matmul_kernel<float, 64>(float const*)"),
])
def test_fused_roofline(cell_name, metric, kernel):
    cell = resolve(cell_name, REPO)
    p, calls = profiled(cell)
    dtype = cell.traffic["TPU"]["compute_dtype"]
    least = sum(counts.fused_least_s(*c, dtype) for c in calls)
    each = 4 * least / len(calls)
    device = [(kernel, i * each, (i + 1) * each) for i in range(len(calls))]
    run = types.SimpleNamespace(trace=trace_of(device, end=len(calls)),
                                profiled=p)
    read = cell.reader(metric)
    assert read(run, cell) == pytest.approx(25.0)
    run.trace = trace_of(device[1:], end=len(calls))
    assert read(run, cell) is None  # launches are not the calls counted
    other = "dn121_mmnn.train_fused_fp32" if cell_name == BF16 else BF16
    assert read(run, resolve(other, REPO)) is None


def test_step_times_by_name():
    cell = resolve(BF16, REPO)
    device = [("void at::native::vectorized_elementwise_kernel<4>", 0, 0.2),
              ("void at::native::reduce_kernel<512, 1>", 0.2, 0.3),
              ("sm90_xmma_fprop_implicit_gemm_bf16", 0.3, 0.7),
              ("sm90_xmma_wgrad_bf16", 0.7, 0.8),
              ("fused_bn_relu_matmul_bf16_kernel", 0.8, 0.9)]
    run = types.SimpleNamespace(trace=trace_of(device),
                                profiled={"supersteps": 8})
    assert cell.reader("elementwise_ms_per_step")(run, cell) == \
        pytest.approx(300 / 8)
    assert cell.reader("conv_ms_per_step")(run, cell) == \
        pytest.approx(500 / 8)
    assert cell.reader("batch_norm_ms_per_step")(run, cell) is None
    run.trace = trace_of(device + [
        ("void (anonymous namespace)::bn_stats_kernel<float, 8>", 0.9, 0.95),
        ("void (anonymous namespace)::bn_backward_dx_kernel<float, 8, true, "
         "true>", 0.95, 1.0)])
    assert cell.reader("batch_norm_ms_per_step")(run, cell) == \
        pytest.approx(100 / 8)
    assert cell.reader("elementwise_ms_per_step")(run, cell) == \
        pytest.approx(300 / 8)


def test_mfu_and_capture():
    cell = resolve(BF16, REPO)
    run = types.SimpleNamespace(window_s=10.0, train_volumes=4800,
                                val_volumes=960, capture_s=1.5)
    flops = (4800 * counts.train_flops(cell)
             + 960 * counts.forward_flops(cell))
    assert cell.reader("train_mfu")(run, cell) == pytest.approx(
        100 * flops / 10.0 / 989e12)
    assert cell.reader("graph_capture_s")(run, cell) == 1.5
    run.capture_s = 0.0
    assert cell.reader("graph_capture_s")(run, cell) is None


def test_every_per_layer_metric_has_a_reader():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        assert (REPO / "perfbench" / "metrics" / f"{m['name']}.py").exists()


# kernel names as the profiler gave them on an H100 (cuDNN 9, torch 2.11),
# with the family each belongs to
RECORDED = [
    ("sm80_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
     "tilesize128x32x32_stage4_warpsize4x1x1_g1_tensor16x8x16_execute_"
     "kernel__5x_cudnn", "conv"),
    ("sm80_xmma_fprop_implicit_gemm_indexed_f32f32_f32f32_f32_nchwkcrs_nchw"
     "_tilesize32x32x8_stage3_warpsize1x2x1_g1_ffma_aligna4_alignc4_execute"
     "_kernel__5x_cudnn", "conv"),
    ("sm90_xmma_dgrad_implicit_gemm_indexed_f32f32_tf32f32_f32_nhwckrsc_"
     "nhwc_tilesize256x64x32_warpgroupsize1x1x1_g1_strided_execute_kernel__"
     "5x_cudnn", "conv"),
    ("sm90_xmma_wgrad_indexed_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nhwc"
     "_tilesize64x128x32_warpgroupsize1x1x1_g1_execute_segment_k_on_kernel"
     "__5x_cudnn", "conv"),
    ("void implicit_convolve_sgemm<float, float, 128, 5, 5, 3, 3, 3, 1, "
     "false, false, true>(int, int, int)", "conv"),
    ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_"
     "impl_nocast<at::native::BinaryFunctor<float, float, float, at::native"
     "::binary_internal::MulFunctor<float> > >", "elementwise"),
    ("void at::native::unrolled_elementwise_kernel<at::native::direct_copy_"
     "kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}, at::native::"
     "memory::LoadWithCast<1>, at::native::memory::StoreWithCast<1> >",
     "elementwise"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "CUDAFunctor_add<float>, std::array<char*, 3ul> >", "elementwise"),
    ("void at::native::reduce_kernel<128, 4, at::native::ReduceOp<float, "
     "at::native::MeanOps<float, float, float, float>, unsigned int, float, "
     "4, 4> >", "elementwise"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "convert_kernel<float, c10::BFloat16> >", "elementwise"),
    ("void cudnn::bn_fw_tr_1C11_kernel_NCHW<float, float, int, 512, true, 1,"
     " true>", None),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<float, float, float,"
     " false, true, (cudnnKernelDataType_t)2>", None),
    ("void fused_bn_relu_matmul_bf16_kernel<128>(CUtensorMap)", None),
    ("Memcpy DtoD (Device -> Device)", None),
    ("void (anonymous namespace)::bn_stats_kernel<float, 8>(float const*, "
     "float const*, (anonymous namespace)::Shape, float const*, float "
     "const*, float*, float*, int, float, float, float, float, float*, "
     "float*, float*, float*, int)", "batch_norm"),
    ("void (anonymous namespace)::bn_normalize_kernel<__nv_bfloat16, 8>("
     "__nv_bfloat16 const*, __nv_bfloat16*, float const*, (anonymous "
     "namespace)::Shape, float const*, float const*, float const*)",
     "batch_norm"),
    ("void (anonymous namespace)::bn_backward_sums_kernel<float, 8, true>("
     "float const*, float const*, float const*, float const*, (anonymous "
     "namespace)::Shape, float const*, float const*, float*)", "batch_norm"),
    ("void (anonymous namespace)::bn_backward_dx_kernel<__nv_bfloat16, 8, "
     "false, false>(__nv_bfloat16 const*, __nv_bfloat16 const*, "
     "__nv_bfloat16 const*, __nv_bfloat16*, float const*, (anonymous "
     "namespace)::Shape, float const*, float const*, float const*, float "
     "const*)", "batch_norm"),
]


@pytest.mark.parametrize("name,want", RECORDED)
def test_kernel_family_by_name(name, want):
    assert kernels.family(name) == want
    # no kernel falls into two families: the order of the tests in
    # ``family`` never decides
    matched = [kernels.ELEMENTWISE.search(name),
               kernels.CONV.search(name.lower()),
               kernels.BATCH_NORM.search(name)]
    assert sum(m is not None for m in matched) == (want is not None)


def test_conv_and_elementwise_readers_share_no_kernel():
    """Nor does the BatchNorm kernels' reader share one with either."""
    cell = resolve(BF16, REPO)
    device = [(name, i, i + 1.0) for i, (name, _) in enumerate(RECORDED)]
    run = types.SimpleNamespace(trace=trace_of(device, end=len(device)),
                                profiled={"supersteps": 1})
    read = {f: cell.reader(f"{f}_ms_per_step")(run, cell)
            for f in ("conv", "elementwise", "batch_norm")}
    for f, ms in read.items():
        assert ms == pytest.approx(1e3 * sum(w == f for _, w in RECORDED))
    # each kernel's second counted once at most: the rest in neither
    neither = sum(w is None for _, w in RECORDED)
    assert sum(read.values()) == pytest.approx(
        1e3 * (len(RECORDED) - neither))
