"""The port's last tools (dynavsr_tpu_torch/tools/convergence_check.py,
edvr_l_step_check.py, profile_ops.py) against the JAX package's
(tools/convergence_check.py, edvr_l_step_check.py, profile_ops.py), on CPU:
the convergence check's data against the JAX tool's PNG tree and its
bicubic val PSNR against JAX's harness, its pass rule; the EDVR-L tool's
steps against direct calls of the port's train steps; every profiler
workload at a tiny shape, and the table's labels on synthetic kernel names;
each tool with jax, flax, cv2 and the JAX package blocked from import."""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import cv2
import numpy as np
import pytest
import torch

from dynavsr_tpu_torch.data.lmdb_native import LmdbReader
from dynavsr_tpu_torch.data.loader import create_dataset
from dynavsr_tpu_torch.tools import convergence_check as conv
from dynavsr_tpu_torch.tools import edvr_l_step_check as step_check
from dynavsr_tpu_torch.tools import profile_ops
from dynavsr_tpu_torch.train.meta import make_meta_train_step, meta_variables
from dynavsr_tpu_torch.train.trainer import make_optimizer, make_schedule, make_train_step
from torch_one_thread import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
# The convergence check's data at a reduced call: 2 clips x 6 frames x 48^2.
REDUCED = dict(n_clips=2, frames=6, gh=48, gw=48)
TINY_EDVR = dict(step_check.EDVR_L, nf=8, front_RBs=1, back_RBs=1, groups=2)
TINY_NET = dict(nf=8, front_RBs=1, back_RBs=1)
# Each profiler workload at a CPU-sized shape (TOF's SpyNet needs 32^2).
TINY_WORKLOADS = {
    "edvr_fwd": dict(b=1, h=16, w=16, **TINY_NET), "dcn": dict(b=1, c=16, h=8, w=8),
    "tof": dict(b=1, h=32, w=32), "duf": dict(b=1, h=16, w=16),
    "adapt_only": dict(n=2, h=8, w=8, **TINY_NET), "stream_step": dict(h=16, w=16, **TINY_NET),
    "adapt": dict(f=3, n=2, h=16, w=16, **TINY_NET)}


def _jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The JAX tool's PNG tree and the port's LMDB trees from the same
    reduced make_data call: (jax root, port GT lmdb, port LQ lmdb)."""
    jroot = str(tmp_path_factory.mktemp("jax"))
    _jax_tool("convergence_check").make_data(jroot, **REDUCED)
    gt, lq = conv.make_data(str(tmp_path_factory.mktemp("port")), **REDUCED)
    return jroot, gt, lq


def _stored(path: str) -> dict:
    """'<clip>_<frame>' -> the uint8 array an LMDB of the tool holds."""
    with LmdbReader(path) as r:
        entries = dict(r.items())
    return {k.decode(): np.frombuffer(v, np.uint8).reshape(
        [int(x) for x in entries[k + b".meta"].decode().split("x")])
        for k, v in entries.items() if not k.endswith(b".meta")}


@pytest.mark.parametrize("leg", ["GT", "LQ"])
def test_convergence_data_matches_jax_tool(trees, leg):
    """Every GT (LQ) frame of the port's LMDB equals the array the JAX
    tool's PNG holds (cv2.imread) within one uint8 level, and all but a few
    pixels exactly: F.interpolate's bicubic is cv2.INTER_CUBIC's rule and a
    4x4 box mean INTER_AREA's at an integer factor."""
    jroot, gt, lq = trees
    got = _stored(gt if leg == "GT" else lq)
    side = REDUCED["gh"] if leg == "GT" else REDUCED["gh"] // 4
    assert len(got) == REDUCED["n_clips"] * REDUCED["frames"]
    n = same = 0
    for key, frame in got.items():
        clip, i = key.split("_")
        want = cv2.imread(f"{jroot}/{leg}/{clip}/{i}.png", cv2.IMREAD_UNCHANGED)
        assert frame.shape == want.shape == (side, side, 3)
        diff = np.abs(frame.astype(int) - want.astype(int))
        assert int(diff.max()) <= 1, key
        n, same = n + diff.size, same + int((diff == 0).sum())
    assert same >= 0.99 * n, (same, n)


def test_bicubic_psnr_matches_jax(trees):
    """The port's bicubic val PSNR on its data equals the JAX tool's
    evaluate_dataset(bicubic_infer, ...) on the JAX tool's data within 1e-3
    dB."""
    import jax.numpy as jnp

    from dynavsr_tpu.data.loader import create_dataset as jax_create_dataset
    from dynavsr_tpu.data.resize import imresize_batched
    from dynavsr_tpu.eval.harness import evaluate_dataset as jax_evaluate_dataset

    jroot, gt, lq = trees
    val = {"phase": "val", "mode": "video_test", "scale": 4, "N_frames": 5,
           "padding": "reflection"}
    want = jax_evaluate_dataset(
        lambda w: imresize_batched(jnp.asarray(w[:, w.shape[1] // 2]), 4.0),
        jax_create_dataset(dict(val, dataroot_GT=f"{jroot}/GT", dataroot_LQ=f"{jroot}/LQ")),
        n_frames=5)["_avg"]["psnr_avg"]
    got = conv.bicubic_psnr(create_dataset(dict(val, dataroot_GT=gt, dataroot_LQ=lq)),
                            torch.device("cpu"))
    assert abs(got - want) <= 1e-3, (got, want)


@pytest.mark.parametrize("seed", range(4))
def test_pass_rule(seed):
    """The JAX tool's rule (tools/convergence_check.py:113-117) on drawn
    loss series and PSNRs: the last logged loss below 0.7x the first, the
    trained PSNR above bicubic; the boundaries fail."""
    rng = np.random.default_rng(seed)
    for _ in range(50):
        losses = list(rng.uniform(0.01, 0.1, size=int(rng.integers(1, 8))))
        psnr, bic = rng.uniform(25, 35, size=2)
        assert conv.passes(losses, psnr, bic) == (losses[-1] < losses[0] * 0.7, psnr > bic)
    assert conv.passes([1.0, 0.7], 30.0, 30.0) == (False, False)
    assert conv.passes([1.0, 0.69], 30.1, 30.0) == (True, True)


def test_edvr_l_tool_steps_equal_direct_train_steps():
    """At a tiny width (nf 8, 1 + 1 blocks, Gd 2; LQ 8^2, SLR 4^2) the
    tool's supervised and meta steps leave the net, and read the losses,
    that direct calls of train/trainer's and train/meta's steps give on the
    same initial weights and batches."""
    cpu = torch.device("cpu")
    args = SimpleNamespace(batch=2, meta_batch=1, repeats=2, device="cpu")
    record, net = step_check.run(args, cpu, net_g=TINY_EDVR, lq=8, slr=4)
    assert record["finite"] and record["params"] == sum(p.numel() for p in net.parameters())

    ref = step_check.make_net(TINY_EDVR, cpu)
    step = make_train_step(ref, step_check.TRAIN, make_optimizer(step_check.TRAIN,
                                                                 ref.parameters()))
    batches = step_check.supervised_batches(cpu, 2, 8)
    sup = [float(step(b, i)["l_pix"]) for i, b in enumerate(batches[:3])]
    opt = make_optimizer(step_check.TRAIN, list(meta_variables(ref).values()))
    meta_step = make_meta_train_step(ref, step_check.META, opt, make_schedule(step_check.TRAIN))
    batches = step_check.meta_batches(cpu, 1, 4)
    meta = [float(meta_step(b, i)["l_outer"]) for i, b in enumerate(batches[:3])]

    assert record["supervised"]["losses"] == sup
    assert record["meta"]["losses"] == meta
    for (name, got), want in zip(net.state_dict().items(), ref.state_dict().values()):
        assert torch.equal(got, want), name


@pytest.mark.parametrize("workload", profile_ops.WORKLOADS)
def test_profiler_workloads_on_cpu(workload, tmp_path):
    """Each workload at a tiny shape: the host table's rows sorted by time,
    their sum at most the total, no kernel launched (CPU tensors take the
    plain ops), a trace written."""
    res = profile_ops.profile_workload(workload, "cpu", groups=2, top=5,
                                       trace_dir=str(tmp_path), **TINY_WORKLOADS[workload])
    times = [ms for _, ms in res["rows"]]
    assert res["on"] == "host" and res["busy_ms"] is None and 0 < len(times) <= 5
    assert times == sorted(times, reverse=True) and all(t >= 0 for t in times)
    assert res["top_ms"] == pytest.approx(sum(times))
    assert res["top_ms"] <= res["total_ms"] * (1 + 1e-9)
    assert res["window_ms"] > 0 and res["launches"] == {}
    assert any(tmp_path.iterdir())


LABELLED = {
    "void dcn::fwd::dcn_fwd_kernel<float, true>(float const*, float const*)": "dcn_fwd",
    "void dcn::bwd::dcn_bwd_data_kernel_any<__nv_bfloat16>(int)": "dcn_bwd_data",
    "void dcn::bwd::dcn_bwd_weight_kernel<float>(int)": "dcn_bwd_weight",
    "void dcn::tng::dcn_fwd_tangent_kernel<float, 3>(int)": "dcn_fwd_tangent",
    "void dcn::tng::dcn_bwd_weight_tangent_kernel<float>(int)": "dcn_bwd_weight_tangent",
    "void dcn::tng::dcn_bwd_data_tangent_kernel_any<float>(int)": "dcn_bwd_data_tangent",
    "void warp_fwd_kernel<2>(float const*)": "warp_fwd",
    "void warp_bwd_kernel(float const*)": "warp_bwd",
    "void warp_bwd_tangent_kernel<true, true, false>(float const*)": "warp_bwd_tangent",
    "void duf::duf_fwd_kernel<__nv_bfloat16>(float const*)": "duf_fwd",
    "void duf::duf_bwd_kernel<float>(float const*)": "duf_bwd",
    "void duf::duf_bwd_x_kernel<float>(float const*)": "duf_bwd",
    "void dcn::fwd::to_channels_last<float>(float const*)": "dcn_fwd helpers",
    "void dcn::bwd::gx_zero<float>(float*)": "dcn_bwd_data helpers",
    "void dcn::bwd::gw_to_oihw<float>(float*)": "dcn_bwd_weight helpers",
    "void dcn::tng::sum_parts(float*, float const*, int)": "dcn_fwd_tangent helpers",
    "sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_tilesize256x64x8":
        "conv fprop",
    "void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816fprop_optimized_bf16>":
        "conv fprop",
    "void implicit_convolve_sgemm<float, float, 1024, 5, 5, 3, 3, 3, 1>(int)": "conv fprop",
    "void cudnn::detail::dgrad_engine<float, 512, 6, 5, 3, 3, 3, false>(int)": "conv dgrad",
    "sm80_xmma_wgrad_implicit_gemm_indexed_f32f32_f32f32_f32": "conv wgrad",
    "void wgrad_alg0_engine<float, 128, 5, 5, 3, 3, 3, false, 512>(int)": "conv wgrad",
    "void fft2d_r2c_32x32<float, false, 0u, false>(float2*)": "conv fft",
    "void pointwise_mult_and_sum_complex<float2, 8, 4>(float2*)": "conv fft",
    "ampere_sgemm_128x64_nn": "gemm",
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64": "gemm",
    "Memcpy DtoH (Device -> Pageable)": "memcpy",
    "Memset (Device)": "memset",
    "void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16>(int)":
        "layout transform",
    "void cudnn::bn_fw_inf_1C11_kernel_NCHW<float, float, true, 1>(float)": "batch norm",
    "void at::native::(anonymous namespace)::upsample_bilinear2d_out_frame<float>(int)":
        "interpolate",
    "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>(int)":
        "elementwise",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>(int)": "reduction",
    "void at::native::(anonymous namespace)::CatArrayBatchedCopy<float>(int)": "cat",
    "void at::native::index_elementwise_kernel<128, 4>(int)": "elementwise",
    "void some_library_kernel(int)": "other",
}


@pytest.mark.parametrize("name", sorted(LABELLED))
def test_kernel_label(name):
    """Each synthetic kernel name's label: the port's kernels by name
    (tangents apart from their first-order stems), their helpers, cuDNN /
    cuBLAS families, the rest by kind, `other` for none."""
    assert profile_ops.kernel_label(name) == LABELLED[name]


class _FakeEvent:
    def __init__(self, name, start_us, us, cuda=True):
        self._n, self._s, self._d, self._c = name, int(start_us * 1e3), int(us * 1e3), cuda

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._c else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return False


def test_op_table_groups_device_events():
    """op_table on a stand-in profile: device events grouped by label,
    summed and sorted, host events and empty ones left out, the busy time
    the union of the spans, the raw names kept for --dump; over `calls`
    calls, each a call's share."""
    events = [_FakeEvent("void dcn::fwd::dcn_fwd_kernel<float, true>(int)", 0, 10),
              _FakeEvent("void dcn::fwd::dcn_fwd_kernel<float, true>(int)", 20, 5),
              _FakeEvent("sm80_xmma_fprop_implicit_gemm_f32", 5, 10),
              _FakeEvent("Memcpy HtoD (Pageable -> Device)", 40, 2),
              _FakeEvent("aten::conv2d", 0, 100, cuda=False),
              _FakeEvent("void at::native::vectorized_elementwise_kernel<4>(int)", 50, 0)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    res = profile_ops.op_table(prof, top=2, dump=3)
    assert res["on"] == "device"
    assert res["rows"] == [("dcn_fwd", pytest.approx(0.015)), ("conv fprop", pytest.approx(0.010))]
    assert res["top_ms"] == pytest.approx(0.025) and res["total_ms"] == pytest.approx(0.027)
    assert res["busy_ms"] == pytest.approx(0.022)  # [0, 15] + [20, 25] + [40, 42]
    assert res["by_label"]["memcpy"] == pytest.approx(0.002)
    assert [n for n, _ in res["raw"]][0].startswith("void dcn::fwd::dcn_fwd_kernel")
    per_call = profile_ops.op_table(prof, top=2, calls=2)  # a profile of two calls
    assert per_call["rows"][0] == ("dcn_fwd", pytest.approx(0.0075))
    assert per_call["total_ms"] == pytest.approx(0.0135)
    assert per_call["busy_ms"] == pytest.approx(0.011)
    assert profile_ops.launch_label("warp_fwd_tangent") == "warp_bwd_tangent"
    assert profile_ops.launch_label("dcn_fwd") == "dcn_fwd"


def test_tools_run_without_jax_cv2_or_the_jax_package(tmp_path):
    """The three tools' modules import, and each runs at a tiny size on the
    CPU, with jax, flax, optax, cv2 and the JAX package unimportable; each
    `main` parses the JAX tool's flags and a host without a card raises on
    their default device."""
    code = f"""
import importlib.abc, json, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'dynavsr_tpu', 'cv2'):
            raise ImportError(f'{{name}} is blocked')
sys.meta_path.insert(0, Block())
from types import SimpleNamespace
import torch
torch.set_num_threads(1)
from dynavsr_tpu_torch.tools import convergence_check, edvr_l_step_check, profile_ops
cpu = torch.device('cpu')
rec, _ = convergence_check.run(SimpleNamespace(iters=2, nf=8, device='cpu'), cpu,
                               root={str(tmp_path)!r},
                               data=dict(n_clips=3, frames=6, gh=64, gw=64))
out = dict(conv=sorted(rec))
rec, _ = edvr_l_step_check.run(SimpleNamespace(batch=1, meta_batch=1, repeats=1, device='cpu'),
                               cpu, net_g={TINY_EDVR!r}, lq=8, slr=4)
out['step'] = rec['finite']
res = profile_ops.profile_workload('dcn', 'cpu', groups=2, top=3, b=1, c=16, h=8, w=8,
                                   trace_dir={str(tmp_path / 'trace')!r})
out['prof'] = res['on']
for mod, argv in ((convergence_check, []), (edvr_l_step_check, []),
                  (profile_ops, ['--workload', 'adapt', '--top', '15', '--groups', '2',
                                 '--dump', '3'])):
    try:
        mod.main(argv)
    except RuntimeError as e:
        out[mod.__name__.rsplit('.', 1)[1]] = 'raised'
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', 'dynavsr_tpu', 'cv2')]
print(json.dumps(dict(out, bad=bad)))
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode == 0, res.stderr[-3000:]
    import json

    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["conv"] == sorted(["iters", "nf", "device", "psnr_bicubic", "psnr_trained",
                                  "l_pix", "ms_per_update", "loss_descended", "beats_bicubic",
                                  "pass"])
    assert got["step"] is True and got["prof"] == "host" and got["bad"] == []
    assert {got.get(k) for k in ("convergence_check", "edvr_l_step_check", "profile_ops")} == {
        "raised"}
