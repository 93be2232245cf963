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

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
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
from torch_one_thread import one_thread  # noqa: F401

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


def _run_both(jax_model, variables, port_model, batches, has_batch_stats, steps=STEPS,
              snapshots=None):
    """`steps` updates on each side from the same weights: (jax metrics,
    port metrics, jax state, lrs of the updates). With a list for
    `snapshots`, each update appends the state it starts from: (JAX's
    variables, the port's state_dict, the port's optimizer state_dict)."""
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
        if snapshots is not None:
            snapshots.append((_np(state.params), copy.deepcopy(port_model.state_dict()),
                              copy.deepcopy(opt.state_dict())))
        state, m = jstep(state, {k: jnp.asarray(v) for k, v in b.items()})
        jm.append({k: float(v) for k, v in m.items()})
        pm.append({k: float(v) for k, v in step({k: torch.from_numpy(v)
                                                 for k, v in b.items()}, i).items()})
    lrs = [schedules.cosine_annealing_restart(
        TRAIN["lr"], TRAIN["periods"], TRAIN["restart_weights"], TRAIN["eta_min"])(i)
        for i in range(steps)]
    return jm, pm, _np(state.params), lrs


def _check_metrics(jm, pm, keys, grad_norm_by_f64=False):
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
    float64 ones, JAX's not. The clip triggered at every step. With
    `grad_norm_by_f64` the caller holds grad_norm by its float64 gauge
    (_check_updates_by_f64) instead."""
    tol = {"l_pix": 2e-4, "dcn_offset_absmean": 2e-4, "grad_norm": 2e-3}
    for i, (a, b) in enumerate(zip(jm, pm)):
        assert set(b) == set(a) == set(keys), (a, b)
        for k in keys:
            if k == "grad_norm" and grad_norm_by_f64:
                continue
            assert b[k] == pytest.approx(a[k], rel=tol[k]), (i, k, a[k], b[k])
    assert all(m["grad_norm"] > TRAIN["grad_clip"] for m in jm)


def _port_f64_step(make_model, state_dict, opt_state, batch, count):
    """The port's train step from (state_dict, optimizer state) evaluated in
    float64 (train mode; the nets' final fp32 cast of their output aside):
    (the weights after it, its grad_norm). With opt_state None only the
    grad_norm, which is the gradient's before the update, is meaningful."""
    cfg = TrainerConfig(**TRAIN)
    model = make_model()
    model.load_state_dict(state_dict)
    model.double()
    opt = make_optimizer(cfg, model.parameters())
    if opt_state is not None:
        opt.load_state_dict(opt_state)  # the moments cast to the parameters' float64
    metrics = make_train_step(model, cfg, opt)(
        {k: torch.from_numpy(v).double() for k, v in batch.items()}, count)
    return model.state_dict(), float(metrics["grad_norm"])


def _jax_f64_grad_norms(jax_model, variables_list, batches):
    """JAX's train-step gradient norm (its loss_fn in train mode) at each
    variables dict on its batch, under jax.enable_x64 with every input in
    float64: one compile for the list."""
    from dynavsr_tpu.train.losses import make_pixel_criterion as jax_criterion

    cfg = JaxTrainerConfig(**TRAIN)
    cri, m = jax_criterion(cfg.criterion, cfg.reduction), jax_model.clone(train=True)

    def loss(v, lqs, gt):
        pred, _ = m.apply(v, lqs, mutable=["batch_stats"])
        return cfg.pixel_weight * cri(pred, gt)

    with jax.enable_x64(True):
        grad = jax.jit(jax.grad(loss))
        f64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa: E731
        return [float(optax.global_norm(grad(f64(v), f64(b["LQs"]), f64(b["GT"]))))
                for v, b in zip(variables_list, batches)]


def _mean_abs_diff(a, b):
    """Mean |a - b| over every trainable entry of two state_dicts."""
    keys = [k for k in a if not k.endswith(("running_mean", "running_var",
                                            "num_batches_tracked"))]
    return float(torch.cat([(a[k].double() - b[k].double()).abs().flatten() for k in keys]).mean())


def _check_updates_by_f64(jm, pm, snapshots, final, batches, jax_model, make_model, frac):
    """grad_norm and the weights of the BatchNorm nets' updates by a float64
    gauge (see test_batch_norm_train_step_matches_jax), each update from the
    state it starts from. The port: its fp32 grad_norm within 2e-3 of its
    own step evaluated in float64 from the same state (_port_f64_step), and
    the weights it reaches apart from that step's by less than `frac` of how
    far the update moved them (mean over every trainable entry). JAX: its
    fp32 grad_norm within 2e-3 of its own under jax.enable_x64, and the two
    packages' float64 grad_norms at JAX's weights within 2e-3 of each
    other. At the first update, where both sides start from the same
    weights, port vs JAX within JAX's own distance from float64 plus 2e-3
    (grad_norm), and plus `frac` of the move (the weights).
    final: the port's state_dict after the last update."""
    tol = 2e-3
    rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
    j64 = _jax_f64_grad_norms(jax_model, [w for w, _, _ in snapshots], batches)
    template = make_model().state_dict()
    ends = [wp for _, wp, _ in snapshots[1:]] + [final]
    for i, ((wj, wp, opt_state), b, end) in enumerate(zip(snapshots, batches, ends)):
        w64, p64 = _port_f64_step(make_model, wp, opt_state, b, i)
        _, p64_jax = _port_f64_step(make_model, jax_params_to_state_dict(wj, template),
                                    None, b, i)
        got, want = pm[i]["grad_norm"], jm[i]["grad_norm"]
        moved, off = _mean_abs_diff(end, wp), _mean_abs_diff(end, w64)
        print(f"update {i}: grad_norm port {got:.7f} (float64 {p64:.7f}), jax {want:.7f} "
              f"(float64 {j64[i]:.7f}; the port's float64 {p64_jax:.7f}); weights moved "
              f"{moved:.3e}, the port's from float64's {off:.3e}")
        assert rel(got, p64) <= tol, (i, got, p64)
        assert rel(want, j64[i]) <= tol, (i, want, j64[i])
        assert rel(p64_jax, j64[i]) <= tol, (i, p64_jax, j64[i])
        assert off < frac * moved, (i, off, moved)
        if i == 0:
            assert rel(got, want) <= rel(want, j64[0]) + tol, (got, want, j64[0])
            jax_end = jax_params_to_state_dict(snapshots[1][0], template)
            assert (_mean_abs_diff(end, jax_end)
                    < _mean_abs_diff(jax_end, w64) + frac * moved), "first update's weights"


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
    own tolerance) plus 1 % of its change.

    TOF holds grad_norm and the mean weight difference by a float64 gauge
    instead, each update from the state it starts from
    (_check_updates_by_f64), because its two-update trajectory is
    ill-conditioned in both packages. TOF's second SpyNet call has a ReLU
    input 4.07e-7 from zero in a float64 evaluation (spynet.block2.bn3 at this
    seed). Which side of it an fp32 evaluation lands on depends on its
    arithmetic, not its framework: the port at one torch thread and JAX's
    plain jitted gradient take the other side of it from float64 (grad_norm
    1.60798 against float64's 1.60519, 1.7e-3), the port at 8 threads and
    JAX's jitted train step do not. Adam turns that first gradient's sign
    changes into a second update from other weights, so the port's second
    grad_norm at one thread is 0.63524 against JAX's 0.62418 (1.8 %), while
    each is within 1e-6 of a float64 evaluation at its own weights. The
    float64 trajectories are no better conditioned: a float64 run of the
    port's two updates reads 0.61687 at the second, as weights 1e-7 apart
    cross another ReLU kink. So each framework's fp32 reading is held
    against float64 from its own state, the two packages' float64 readings
    against each other at JAX's weights, and port against JAX directly only
    at the first update, where both start from the same weights."""
    if net == "TOF":
        variables, jax_model, make_model = tof_variables, JaxTOFlow(), lambda: TOFlow(nframes=3)
        batches = _batches(3, (2, 3, 16, 16, 3), (2, 16, 16, 3), seed=2)
    else:
        variables, jax_model = duf_variables, JaxDUF(dense1_layers=1)
        make_model = lambda: DUF(dense1_layers=1)  # noqa: E731
        batches = _batches(3, (2, 7, 8, 8, 3), (2, 32, 32, 3), seed=3)
    model = make_model()
    snapshots = [] if net == "TOF" else None
    jm, pm, jparams, lrs = _run_both(jax_model, variables, model, batches, True, steps=2,
                                     snapshots=snapshots)
    _check_metrics(jm, pm, ("l_pix", "grad_norm"), grad_norm_by_f64=net == "TOF")
    if net == "TOF":
        _check_updates_by_f64(jm, pm, snapshots, model.state_dict(), batches, jax_model,
                              make_model, 0.05)
    else:
        _moved_far_more_than_they_differ(variables, jparams, model, 0.05)
    held = jnp.asarray(batches[-1]["LQs"])
    want = np.asarray(jax.jit(jax_model.apply)(jparams, held))
    before = np.asarray(jax.jit(jax_model.apply)(variables, held))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(np.array(held))).numpy()
    moved = float(np.abs(want - before).max())
    print(f"{net}: SR moved {moved:.3e}, |port - jax| {float(np.abs(got - want).max()):.3e}")
    np.testing.assert_allclose(got, want, atol=0.05 * moved)
    want_stats = _check_params(jparams, model, lrs)
    sd = model.state_dict()
    start = jax_params_to_state_dict(variables)
    assert want_stats
    for k, v in want_stats.items():
        move = float((v - start[k]).abs().max())
        diff = float((sd[k] - v).abs().max())
        assert diff <= 1e-5 + 1e-2 * move, (k, diff, move)
    assert any(float((sd[k] - start[k]).abs().max()) > 1e-3 for k in want_stats)
