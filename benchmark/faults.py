"""Faults planted in the program under test, for the checks that the
comparison deciding `correct` fails on them: in the CPU tests
(benchmark/tests/test_bench_faults.py) and at a cell's own size on the card
(benchmark/controls.py --fault). Each takes pytest's `monkeypatch` (or
anything with its `setattr`) and the cell's name, and patches the port's
modules for as long as the patch lives."""

import torch


def unchanged(monkeypatch, cell):
    """The adaptation's optimizer (the meta step's update) leaves the
    weights as they were."""
    if cell == "edvr_m.meta_reds":
        from dynavsr_tpu_torch.train import meta
        real = meta.apply_update

        def frozen(optimizer, params, lr, clip):
            before = [p.detach().clone() for p in params]
            out = real(optimizer, params, lr, clip)
            with torch.no_grad():
                for p, b in zip(params, before):
                    p.copy_(b)
            return out
        monkeypatch.setattr(meta, "apply_update", frozen)
        return
    from dynavsr_tpu_torch.adapt import adaptation

    class Still(torch.optim.SGD):
        def step(self, closure=None):
            return None
    monkeypatch.setattr(adaptation, "_make_opt", lambda cfg, params: Still(params, lr=cfg.lr))


def half_batch(monkeypatch, cell):
    """The loss is the mean over the first half of the batch's rows."""
    if cell == "edvr_m.meta_reds":
        from dynavsr_tpu_torch.train import meta as mod
    else:
        from dynavsr_tpu_torch.adapt import adaptation as mod
    real = mod.charbonnier_loss
    monkeypatch.setattr(mod, "charbonnier_loss",
                        lambda p, t, **k: real(p[: p.shape[0] // 2], t[: t.shape[0] // 2], **k))


def altered(monkeypatch, cell):
    """Every SR frame comes out with one value off by 1."""
    def bump(sr):
        sr = sr.clone()
        sr[..., 0, 0, 0] += 1.0
        return sr
    if cell == "edvr_m.live4_qcif":
        from dynavsr_tpu_torch.eval import streaming
        real = streaming._StreamCore._emit
        monkeypatch.setattr(streaming._StreamCore, "_emit", lambda self, idx: bump(real(self, idx)))
        return
    from dynavsr_tpu_torch.adapt import adaptation
    real = adaptation.chunked_apply
    monkeypatch.setattr(adaptation, "chunked_apply", lambda *a, **k: bump(real(*a, **k)))



FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "altered": altered}


def applies(cell: str, fault: str) -> bool:
    """A training cell has no answer to alter."""
    return not (cell == "edvr_m.meta_reds" and fault == "altered")
