"""The port's supervised training step and lr schedules against the JAX
package's (dynavsr_tpu/train/trainer.py, schedules.py), on CPU.

The train steps start from the JAX init, carried over with
convert/from_jax.py:jax_params_to_state_dict (EDVR's offset convs redrawn
off zero, so the DCNs sample off the grid from the first step), and take 3
updates (EDVR; 2 for the BatchNorm nets) on the same numpy batches: cosine
restarts over periods of 2, a grad_clip below the gradients' norm (the
clip triggers), and decoupled weight decay of 0.1 (large enough that L2
on the gradient, torch.optim.Adam's weight_decay, would miss the mean
check below). Each step's l_pix, grad_norm and offset metric, then the SR
of a held-out window, then every parameter are compared.

The parameters' tolerance follows from Adam: an update moves a weight by
lr * m_hat / (sqrt(v_hat) + eps), at most about lr for each of these
first updates, whatever the gradient's size. Where a gradient is float
noise around zero, its sign (and so the update's) may differ between the
two frameworks, so a weight may differ by up to 2 lr an update: the bound
is 2 * (sum of the updates' lr) absolute, plus 1e-5 of the weight for the
arithmetic of the rest; and on average the two sides' weights differ by
less than a small share of how far the updates moved them (1 % for EDVR,
5 % for the BatchNorm nets: see their test). The running statistics move
by the layers' EMA, not by Adam (see the BatchNorm test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynavsr_tpu.models.duf import DUF as JaxDUF
from dynavsr_tpu.models.edvr import EDVR as JaxEDVR
from dynavsr_tpu.models.tof import TOFlow as JaxTOFlow
from dynavsr_tpu.train import schedules as jax_schedules
from dynavsr_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from dynavsr_tpu.train.trainer import TrainState
from dynavsr_tpu.train.trainer import make_optimizer as jax_make_optimizer
from dynavsr_tpu.train.trainer import make_train_step as jax_make_train_step
from dynavsr_tpu_torch.convert.from_jax import jax_params_to_state_dict
from dynavsr_tpu_torch.models.duf import DUF
from dynavsr_tpu_torch.models.edvr import EDVR
from dynavsr_tpu_torch.models.tof import TOFlow
from dynavsr_tpu_torch.train import schedules
from dynavsr_tpu_torch.train.losses import make_pixel_criterion
from dynavsr_tpu_torch.train.trainer import TrainerConfig, make_optimizer, make_train_step

EDVR_CFG = dict(nf=8, nframes=3, groups=2, front_RBs=1, back_RBs=1)
TRAIN = dict(lr=4e-4, periods=(2, 2), restart_weights=(1.0, 0.5), eta_min=1e-7,
             weight_decay=0.1, grad_clip=1e-3)
STEPS = 3
F32_EPS = float(np.finfo(np.float32).eps)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ------------------------------------------------------------- schedules
def _close(port, jax_sched, counts, peak):
    """JAX evaluates the schedule in float32, the port in float64. The
    cosine's 1 + cos(pi t) cancels near a period's end, where float32's
    rounding of cos (a few 2^-24 absolute) is amplified relative to the
    small lr: there the two may differ by a few float32 ulps of the peak lr.
    So |port - jax| <= 1e-7 |jax| + 2 eps32 * peak; away from a period's
    end that is 1e-7 relative."""
    for c in counts:
        want, got = float(jax_sched(c)), port(c)
        assert abs(got - want) <= 1e-7 * abs(want) + 2 * F32_EPS * peak, (c, got, want)


@pytest.mark.parametrize("weights", [(1.0, 0.5, 0.25), (0.5, 0.25)],
                         ids=["per-period", "per-restart"])
def test_cosine_annealing_restart_matches_jax(weights):
    """Every count of 3 periods (7, 10, 13) and 5 past the end (clamped),
    with restart weights per period and per restart (a 1 prepended)."""
    args = (4e-4, (7, 10, 13), weights, 1e-7)
    _close(schedules.cosine_annealing_restart(*args),
           jax_schedules.cosine_annealing_restart(*args), range(35), 4e-4)
    with pytest.raises(ValueError):
        schedules.cosine_annealing_restart(4e-4, (7, 10, 13), (1.0,))


@pytest.mark.parametrize("restarts", [(), (6, 11)], ids=["no-restarts", "restarts"])
def test_multistep_restart_matches_jax(restarts):
    """Milestones (2, 4, 8, 9, 13), gamma 0.5, with and without restarts
    (weights 0.5, 0.25), at every count to 16."""
    weights = (0.5, 0.25) if restarts else ()
    args = (1e-3, (2, 4, 8, 9, 13), 0.5, restarts, weights)
    _close(schedules.multistep_restart(*args), jax_schedules.multistep_restart(*args),
           range(16), 1e-3)


def test_warmup_matches_jax():
    """with_warmup(5) over a cosine schedule: (c + 1) / 5 for c < 5."""
    inner = (4e-4, (6, 6), None, 1e-7)
    _close(schedules.with_warmup(schedules.cosine_annealing_restart(*inner), 5),
           jax_schedules.with_warmup(jax_schedules.cosine_annealing_restart(*inner), 5),
           range(14), 4e-4)
    base = schedules.cosine_annealing_restart(*inner)
    assert schedules.with_warmup(base, 0) is base


@pytest.mark.parametrize("name", ["cb", "l1", "l2"])
def test_pixel_criteria_match_jax(name):
    """Each criterion and reduction: 1e-6 relative (fp32 sums)."""
    from dynavsr_tpu.train.losses import make_pixel_criterion as jax_criterion

    rng = np.random.default_rng(0)
    a, b = (rng.random((2, 8, 8, 3)).astype(np.float32) for _ in range(2))
    for red in ("mean", "sum"):
        want = float(jax_criterion(name, red)(jnp.asarray(a), jnp.asarray(b)))
        got = float(make_pixel_criterion(name, red)(torch.from_numpy(a), torch.from_numpy(b)))
        assert got == pytest.approx(want, rel=1e-6)


# ------------------------------------------------------------ train steps
def _batches(n, lq_shape, gt_shape, seed):
    rng = np.random.default_rng(seed)
    return [{"LQs": rng.random(lq_shape).astype(np.float32),
             "GT": rng.random(gt_shape).astype(np.float32)} for _ in range(n)]


def _run_both(jax_model, variables, port_model, batches, has_batch_stats, steps=STEPS):
    """`steps` updates on each side from the same weights: (jax metrics,
    port metrics, jax state, lrs of the updates)."""
    jcfg, cfg = JaxTrainerConfig(**TRAIN), TrainerConfig(**TRAIN)
    state = TrainState.create(apply_fn=jax_model.apply, params=variables,
                              tx=jax_make_optimizer(jcfg))
    jstep = jax_make_train_step(jax_model, jcfg, donate=False, has_batch_stats=has_batch_stats)
    port_model.load_state_dict(jax_params_to_state_dict(variables, port_model.state_dict()))
    opt = make_optimizer(cfg, port_model.parameters())
    assert isinstance(opt, torch.optim.AdamW)
    step = make_train_step(port_model, cfg, opt)
    jm, pm = [], []
    for i, b in enumerate(batches[:steps]):
        state, m = jstep(state, {k: jnp.asarray(v) for k, v in b.items()})
        jm.append({k: float(v) for k, v in m.items()})
        pm.append({k: float(v) for k, v in step({k: torch.from_numpy(v)
                                                 for k, v in b.items()}, i).items()})
    lrs = [schedules.cosine_annealing_restart(
        TRAIN["lr"], TRAIN["periods"], TRAIN["restart_weights"], TRAIN["eta_min"])(i)
        for i in range(steps)]
    return jm, pm, _np(state.params), lrs


def _check_metrics(jm, pm, keys):
    """Per step: l_pix and the offset metric 2e-4 relative (the first step
    agrees to 1e-6; after it the forwards run weights that may differ by up
    to the bound below where Adam turned a gradient's sign); grad_norm 2e-3
    relative. A (leaky)
    ReLU whose input lies within float32 rounding of 0 is on in one
    framework and off in the other, which moves that activation's gradient
    by its whole size and a row of a weight's gradient with it: in DUF's
    residual head at this seed one of 32768 such inputs (-3.5e-7 in a
    float64 evaluation) moves conv3d_r1's gradient by 4 % of its largest
    entry, and the port's fp32 gradients are that one flip away from the
    float64 ones, JAX's not. The clip triggered at every step."""
    tol = {"l_pix": 2e-4, "dcn_offset_absmean": 2e-4, "grad_norm": 2e-3}
    for i, (a, b) in enumerate(zip(jm, pm)):
        assert set(b) == set(a) == set(keys), (a, b)
        for k in keys:
            assert b[k] == pytest.approx(a[k], rel=tol[k]), (i, k, a[k], b[k])
    assert all(m["grad_norm"] > TRAIN["grad_clip"] for m in jm)


def _moved_far_more_than_they_differ(start_variables, want_variables, model, frac):
    """The updates moved the weights (mean |change| over every trainable
    entry), and the two sides differ by less than `frac` of that."""
    start = jax_params_to_state_dict(start_variables)
    want = jax_params_to_state_dict(want_variables)
    got = model.state_dict()
    keys = [k for k in want if not k.endswith(("running_mean", "running_var",
                                                "num_batches_tracked"))]
    moved = np.mean(np.concatenate([(got[k] - start[k]).abs().flatten().numpy() for k in keys]))
    diff = np.mean(np.concatenate([(got[k] - want[k]).abs().flatten().numpy() for k in keys]))
    print(f"mean |move| {moved:.3e}, mean |port - jax| {diff:.3e}")
    assert diff < frac * moved


def _check_params(want_variables, model, lrs):
    want = jax_params_to_state_dict(want_variables)
    got = model.state_dict()
    bound = 2 * sum(lrs)
    stats = ("running_mean", "running_var", "num_batches_tracked")
    for k, v in want.items():
        if k.endswith(stats):
            continue
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-5, atol=bound, err_msg=k)
    return {k: v for k, v in want.items() if k.endswith(("running_mean", "running_var"))}


@pytest.fixture(scope="module")
def edvr_variables():
    """The JAX init of a tiny EDVR with its offset convs redrawn N(0, 0.05)
    (zero-initialised, they would leave every DCN on the pixel grid)."""
    x = jnp.zeros((1, 3, 16, 16, 3))
    v = _np(jax.jit(JaxEDVR(**EDVR_CFG).init)(jax.random.PRNGKey(0), x))
    rng = np.random.default_rng(0)

    def redraw(tree):
        for k, leaf in tree.items():
            if k == "conv_offset_mask":
                leaf["kernel"] = (rng.standard_normal(leaf["kernel"].shape) * 0.05
                                  ).astype(np.float32)
            elif isinstance(leaf, dict):
                redraw(leaf)

    redraw(v["params"])
    return v


def test_edvr_train_step_matches_jax(edvr_variables):
    """Tiny EDVR (nf 8, 3 frames, Gd 2, 1 + 1 blocks), batch 2 of 16x16 LR:
    3 updates, then the SR of a held-out batch 1e-4 absolute (outputs of
    O(1), weights within the bound above) and every parameter."""
    batches = _batches(STEPS + 1, (2, 3, 16, 16, 3), (2, 64, 64, 3), seed=1)
    model = EDVR(**EDVR_CFG)
    jax_model = JaxEDVR(**EDVR_CFG)
    jm, pm, jparams, lrs = _run_both(jax_model, edvr_variables, model, batches, False)
    _check_metrics(jm, pm, ("l_pix", "grad_norm", "dcn_offset_absmean"))
    assert all(m["dcn_offset_absmean"] > 0 for m in jm)
    held = batches[-1]["LQs"]
    want = np.asarray(jax.jit(jax_model.apply)(jparams, jnp.asarray(held)))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(held)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    _check_params(jparams, model, lrs)
    _moved_far_more_than_they_differ(edvr_variables, jparams, model, 1e-2)


@pytest.fixture(scope="module")
def tof_variables():
    x = jnp.asarray(np.random.default_rng(0).random((1, 3, 16, 16, 3)).astype(np.float32))
    return _np(jax.jit(JaxTOFlow().init)(jax.random.PRNGKey(0), x))


@pytest.fixture(scope="module")
def duf_variables():
    x = jnp.asarray(np.random.default_rng(0).random((1, 7, 8, 8, 3)).astype(np.float32))
    return _np(jax.jit(JaxDUF(dense1_layers=1).init)(jax.random.PRNGKey(0), x))


@pytest.mark.parametrize("net", ["TOF", "DUF"])
def test_batch_norm_train_step_matches_jax(net, tof_variables, duf_variables):
    """TOFlow (3 frames of 16x16, SR of the same size) and DUF-16L's
    layout with one dense layer a block (7 frames of 8x8 -> 32x32), batch
    2, 2 updates in train mode (batch statistics; running statistics by
    the layers' EMA, flax's rule). Metrics and parameters as EDVR's. Adam
    turns more of these nets' gradients' float noise into updates of
    opposite sign (after 2 updates DUF has ~180k of 1.3M weights apart by
    up to 2 lr; EDVR almost none), so what depends on all the weights is
    held relative to how far the updates moved it: the mean weight
    difference below 5 % of the mean change, the SR of a held-out batch in
    eval mode (so on the running statistics) within 5 % of its largest
    change, and every running statistic within 1e-5 (the train forwards'
    own tolerance) plus 1 % of its change (the second update's batch
    statistics come from the weights held above). TOF's coarsest SpyNet level
    normalises 2x2 pixels, which makes its gradients sensitive to float
    rounding: from the same weights the port's fp32 gradients of the
    coarsest block are ~4e-7 from a float64 evaluation, JAX's (flax's
    E[x^2] - E[x]^2 variance) ~4e-5, and a third update can carry that
    into a 1e-3 change of the gradient's norm. Two updates, as the running statistics are checked
    after, stay inside the stated tolerances."""
    if net == "TOF":
        variables, jax_model, model = tof_variables, JaxTOFlow(), TOFlow(nframes=3)
        batches = _batches(3, (2, 3, 16, 16, 3), (2, 16, 16, 3), seed=2)
    else:
        variables, jax_model = duf_variables, JaxDUF(dense1_layers=1)
        model = DUF(dense1_layers=1)
        batches = _batches(3, (2, 7, 8, 8, 3), (2, 32, 32, 3), seed=3)
    jm, pm, jparams, lrs = _run_both(jax_model, variables, model, batches, True, steps=2)
    _check_metrics(jm, pm, ("l_pix", "grad_norm"))
    held = jnp.asarray(batches[-1]["LQs"])
    want = np.asarray(jax.jit(jax_model.apply)(jparams, held))
    before = np.asarray(jax.jit(jax_model.apply)(variables, held))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(np.array(held))).numpy()
    moved = float(np.abs(want - before).max())
    print(f"{net}: SR moved {moved:.3e}, |port - jax| {float(np.abs(got - want).max()):.3e}")
    np.testing.assert_allclose(got, want, atol=0.05 * moved)
    want_stats = _check_params(jparams, model, lrs)
    _moved_far_more_than_they_differ(variables, jparams, model, 0.05)
    sd = model.state_dict()
    start = jax_params_to_state_dict(variables)
    assert want_stats
    for k, v in want_stats.items():
        move = float((v - start[k]).abs().max())
        diff = float((sd[k] - v).abs().max())
        assert diff <= 1e-5 + 1e-2 * move, (k, diff, move)
    assert any(float((sd[k] - start[k]).abs().max()) > 1e-3 for k in want_stats)
