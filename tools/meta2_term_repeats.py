"""chip_smoke.py's phase 11 for the backbones named (11b: DUF-16L, the
default; 11a: TOFlow; 11a,11b: both): their meta-training, their kernel
calls against plain, and the second-order term's float64 gauge, N times on
one card, each from a fresh root after one 10a MFDN: how often the term
check fails, and each try's readings (the `[meta2 11c DUF]` /
`[meta2 11c TOF]` lines). A failing check is printed and the loop goes on.

    python3 tools/meta2_term_repeats.py [N] [11a|11b|11a,11b]   (on a machine with the card)
"""
import os
import sys
import tempfile
import traceback

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from dynavsr_tpu_torch.models.video_base_model import DownscalerModel  # noqa: E402

smi = cs.phase_device()
cs.phase_build()
gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
orig_term = cs.second_order_term
state = {"n": 0, "fails": 0}


def term(tag, model, batch, *a, **k):
    state["n"] += 1
    try:
        return orig_term(tag, model, batch, *a, **k)
    except RuntimeError:
        traceback.print_exc()
        state["fails"] += 1
        # The phase reads the configs' loss next at the check's alpha: the first.
        return {"alpha": k.get("alphas", cs.ALPHAS)[0]}


cs.second_order_term = term
tags = (sys.argv[2] if len(sys.argv) > 2 else "11b").split(",")
cs.META2_RUNS = {t: cs.META2_RUNS[t] for t in tags}
with tempfile.TemporaryDirectory(prefix="meta2_repeats_") as root:
    vimeo = cs.write_vimeo_lmdb(gen, root)
    run = cs.DOWN_RUNS["10a"]
    m = cs.train_and_resume("10a", lambda res, r=run: cs.downscaler_opt(
        r["which"], r["niter"], r["save"], vimeo, root, resume=res),
        run["niter"], run["save"], DownscalerModel, per_update={})
    est = f"{m['opt']['path']['models']}/{run['niter']}_G.pth"
    for rep in range(int(sys.argv[1]) if len(sys.argv) > 1 else 6):
        sub = os.path.join(root, f"rep{rep}")
        os.makedirs(sub)
        try:
            cs.phase_meta2(smi, gen, vimeo, est, sub)
        except Exception:
            traceback.print_exc()
        print(f"[repeats] run {rep}: {state['fails']} failed term checks of {state['n']}",
              flush=True)
print(smi)
