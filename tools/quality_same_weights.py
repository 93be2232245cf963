"""The blind-adaptation protocol's meta leg and tests in both packages from
one set of trained weights, on the CPU.

The port's tool (python -m dynavsr_tpu_torch.tools.blind_adaptation_check)
and the JAX package's (tools/blind_adaptation_check.py) each train their
own VSR net and MFDN from their own random streams, so a gap between their
adaptation gains may come from the training or from the meta leg and the
tests. This script takes the training out of it:

  1. the port's tool, --meta-iters 0, under <root>/torch: it trains the VSR
     net and the estimator and runs the tests;
  2. every `<iter>_G.pth` it wrote is converted to the JAX package's params
     (dynavsr_tpu.convert.torch_import over a jax.eval_shape template) and
     saved as an orbax checkpoint at the same place under <root>/jax, where
     the JAX tool finds it and skips its training;
  3. the JAX tool, --meta-iters 0 and then --meta-iters M, under <root>/jax;
  4. the port's tool, --meta-iters M, under <root>/torch.

With --jax-estimator only the VSR net is converted: the JAX tool trains
its own estimator, so the two runs differ by the estimator alone.

Both tools build the same data from --seed (the port's LMDB frames are the
JAX tool's PNG frames within one uint8 level). Each tool runs in a process
of its own; the JAX compilation cache goes under <root>. Prints one JSON
line: the four records, and the JAX tool's readings minus the port's.

    python tools/quality_same_weights.py --root /tmp/qsw --meta-iters 50 -- \\
        --nf 16 --front-rbs 1 --back-rbs 1 --iters 300 --mfdn-iters 300 \\
        --adapt-lrs 1e-5

    python tools/quality_same_weights.py --root /tmp/qsw_tof --meta-iters 150 \\
        --bn-modes train_ema grad_stats -- --arch tof --iters 600 --mfdn-iters 600

The arguments after `--` go to both tools unchanged (--arch edvr, tof or
duf). With --bn-modes the four records are taken once a mode, from the
same trained and meta-trained nets; a record whose meta leg exists under
the root is reused by both tools.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import os.path as osp
import subprocess
import sys
import time

import numpy as np

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, ROOT)


def run_tool(cmd: list, log: str, env: dict) -> dict:
    """Run one tool to its end (its exit code only says whether the gain
    passed 0.05 dB) and return the JSON record it printed."""
    t0 = time.perf_counter()
    with open(log, "w") as f:
        rc = subprocess.run(cmd, cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT).returncode
    lines = [ln for ln in open(log).read().splitlines() if ln.startswith("{")]
    if not lines:
        raise RuntimeError(f"{' '.join(cmd)} exited {rc} with no record; see {log}")
    record = json.loads(lines[-1])
    record["_seconds"] = time.perf_counter() - t0
    return record


def to_orbax(torch_root: str, jax_root: str, tool_args: list, estimator: bool = True) -> list:
    """Save every `<iter>_G.pth` under torch_root/experiments as the JAX
    package's orbax checkpoint at the same relative place under jax_root
    (the VSR net from the tools' network_G for --arch, the estimator nf 64
    on the VSR net's window; without `estimator`, the VSR net only). The
    template is the model's whole variables dict, so a TOF or DUF net's
    BatchNorm running statistics are converted beside its parameters, and
    the JAX tool's loader (load_network with that dict as `like`) restores
    them."""
    import jax
    import jax.numpy as jnp

    from dynavsr_tpu.convert.torch_import import convert_state_dict, load_torch_checkpoint
    from dynavsr_tpu.models.networks import define_G
    from dynavsr_tpu.train.checkpoint import save_network
    from dynavsr_tpu_torch.tools.blind_adaptation_check import build_parser, vsr_network

    args = build_parser().parse_args(tool_args)
    net_g, _ = vsr_network(args)
    x = jnp.zeros((1, int(net_g.get("nframes", 5)), 32, 32, 3), jnp.float32)
    written = []
    for pth in sorted(glob.glob(f"{torch_root}/experiments/*/models/*_G.pth")):
        rel = osp.relpath(pth, torch_root)
        name = rel.split(os.sep)[1]
        if name.startswith(("mfdn", "sfdn")):
            if not estimator:
                continue
            net = {"which_model_G": args.estimator.upper(), "nf": 64}
        elif name.startswith("vsr_"):
            net = net_g
        else:
            continue
        model = define_G({"scale": 4, "network_G": net})
        template = jax.eval_shape(model.init, jax.random.PRNGKey(0), x)
        params = convert_state_dict(load_torch_checkpoint(pth), template)
        it = int(osp.basename(pth).split("_")[0])
        written.append(save_network(osp.join(jax_root, osp.dirname(rel)), it, params))
    return written


def readings(record: dict) -> dict:
    """The numbers the comparison reads from one record."""
    out = {"psnr_bicubic_matched": record["psnr_bicubic_matched"],
           "mean_gain_db": record["mean_gain_db"]}
    for tag, leg in record["per_kernel"].items():
        for k in ("psnr_no_adapt", "psnr_adapted", "adaptation_gain_db",
                  "mfdn_rmse_vs_true_slr"):
            out[f"{tag}/{k}"] = leg[k]
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    own, tool_args = (argv[:argv.index("--")], argv[argv.index("--") + 1:]) if "--" in argv \
        else (argv, [])
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="a directory for both tools' run dirs")
    ap.add_argument("--meta-iters", type=int, default=150,
                    help="the meta leg's iterations (0: the records without meta only)")
    ap.add_argument("--jax-estimator", action="store_true",
                    help="convert the VSR net only; the JAX tool trains its own estimator")
    ap.add_argument("--bn-modes", nargs="+", default=[None],
                    choices=["auto", "grad_stats", "train_ema"],
                    help="run the four records once a --bn-mode (the trained and the "
                         "meta-trained nets are reused; only the tests run again)")
    ap.add_argument("--skip-meta0", action="store_true",
                    help="take only the meta records (the nets under --root already trained)")
    ap.add_argument("--jax-cache", default=None,
                    help="the JAX compilation cache (default <root>/jax_cache); one shared "
                         "by several roots compiles each step once")
    args = ap.parse_args(own)
    torch_root, jax_root = osp.join(args.root, "torch"), osp.join(args.root, "jax")
    os.makedirs(jax_root, exist_ok=True)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               DYNAVSR_COMPILATION_CACHE=args.jax_cache or osp.join(args.root, "jax_cache"))
    port = [sys.executable, "-m", "dynavsr_tpu_torch.tools.blind_adaptation_check",
            "--device", "cpu", "--root", torch_root]
    jax_tool = [sys.executable, osp.join("tools", "blind_adaptation_check.py"),
                "--root", jax_root]
    meta = ["--meta-iters", str(args.meta_iters)]
    written, by_mode = None, {}
    for mode in args.bn_modes:
        these = tool_args + (["--bn-mode", mode] if mode else [])

        def record(tool: list, name: str, iters: list) -> dict:
            log = osp.join(args.root, f"{name}{'_' + mode if mode else ''}.log")
            return run_tool(tool + these + iters, log, env)

        records = {}
        if not args.skip_meta0:  # the port trains here, so its weights exist for to_orbax
            records["port_meta0"] = record(port, "port_meta0", ["--meta-iters", "0"])
        if written is None:
            written = to_orbax(torch_root, jax_root, tool_args, estimator=not args.jax_estimator)
        if not args.skip_meta0:
            records["jax_meta0"] = record(jax_tool, "jax_meta0", ["--meta-iters", "0"])
        if args.meta_iters:
            records["jax_meta"] = record(jax_tool, "jax_meta", meta)
            records["port_meta"] = record(port, "port_meta", meta)
        diff = {}
        for m in sorted({k.split("_", 1)[1] for k in records}):
            j, p = readings(records[f"jax_{m}"]), readings(records[f"port_{m}"])
            diff[m] = {k: float(np.round(j[k] - p[k], 4)) for k in j}
        by_mode[mode or "default"] = {"jax_minus_port": diff, "records": records}
        print(json.dumps({"bn_mode": mode, "jax_minus_port": diff}), flush=True)
    out = {"tool_args": tool_args, "meta_iters": args.meta_iters,
           "jax_estimator": args.jax_estimator,
           "converted": [osp.relpath(w, jax_root) for w in written]}
    if len(by_mode) == 1:
        out.update(next(iter(by_mode.values())))
    else:
        out["by_bn_mode"] = by_mode
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
