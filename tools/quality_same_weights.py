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

The arguments after `--` go to both tools unchanged (EDVR only).
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
    (the VSR net from the tools' network_G, the estimator nf 64; without
    `estimator`, the VSR net only)."""
    import jax
    import jax.numpy as jnp

    from dynavsr_tpu.convert.torch_import import convert_state_dict, load_torch_checkpoint
    from dynavsr_tpu.models.networks import define_G
    from dynavsr_tpu.train.checkpoint import save_network
    from dynavsr_tpu_torch.tools.blind_adaptation_check import build_parser

    args = build_parser().parse_args(tool_args)
    if args.arch != "edvr":
        raise NotImplementedError("this comparison runs the EDVR protocol only")
    net_g = {"which_model_G": "EDVR", "nf": args.nf, "nframes": 5, "groups": args.groups,
             "front_RBs": args.front_rbs, "back_RBs": args.back_rbs, "dtype": "bfloat16"}
    x = jnp.zeros((1, 5, 32, 32, 3), jnp.float32)
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
    ap.add_argument("--meta-iters", type=int, default=150)
    ap.add_argument("--jax-estimator", action="store_true",
                    help="convert the VSR net only; the JAX tool trains its own estimator")
    args = ap.parse_args(own)
    torch_root, jax_root = osp.join(args.root, "torch"), osp.join(args.root, "jax")
    os.makedirs(jax_root, exist_ok=True)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               DYNAVSR_COMPILATION_CACHE=osp.join(args.root, "jax_cache"))
    port = [sys.executable, "-m", "dynavsr_tpu_torch.tools.blind_adaptation_check",
            "--device", "cpu", "--root", torch_root] + tool_args
    jax_tool = [sys.executable, osp.join("tools", "blind_adaptation_check.py"),
                "--root", jax_root] + tool_args
    meta = ["--meta-iters", str(args.meta_iters)]
    records = {"port_meta0": run_tool(port + ["--meta-iters", "0"],
                                      osp.join(args.root, "port_meta0.log"), env)}
    written = to_orbax(torch_root, jax_root, tool_args, estimator=not args.jax_estimator)
    records["jax_meta0"] = run_tool(jax_tool + ["--meta-iters", "0"],
                                    osp.join(args.root, "jax_meta0.log"), env)
    records["jax_meta"] = run_tool(jax_tool + meta, osp.join(args.root, "jax_meta.log"), env)
    records["port_meta"] = run_tool(port + meta, osp.join(args.root, "port_meta.log"), env)
    diff = {}
    for m in ("meta0", "meta"):
        j, p = readings(records[f"jax_{m}"]), readings(records[f"port_{m}"])
        diff[m] = {k: float(np.round(j[k] - p[k], 4)) for k in j}
    print(json.dumps({"tool_args": tool_args, "meta_iters": args.meta_iters,
                      "jax_estimator": args.jax_estimator,
                      "converted": [osp.relpath(w, jax_root) for w in written],
                      "jax_minus_port": diff, "records": records}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
