"""The port's data-parallel training step against the JAX package's, on the CPU.

Two gloo ranks (spawned processes, ``parallel.multihost_dryrun.launch``) at
one image each run the port's data-parallel step; the JAX package runs
``make_train_step(config, axis_name="data")`` under ``shard_map`` on a
2-device mesh of the virtual CPU devices (what ``make_data_parallel_train_step``
jits), plus its reduced gradients in the same program. Both get the same
bridged flax weights, the same rows (JAX's device i, the port's rank i) and
the same draws: JAX's own, from ``fold_in(rng, i)`` as its step folds the
axis index. The configuration is ``test_torch_port_train_step``'s tiny
float32 one.

One launch of the two ranks serves every test here: they run the step
under both batch-norm settings, the guard case and, on rank 0 in a group of
its own, the world-size-1 case, while the JAX package computes its
references in this process.

Tolerances, those of ``test_torch_port_train_step`` (which says why the
gradients need a step-wide term): each loss <= 1e-5 relative; each reduced
gradient leaf, read from the step's own first adamax moment (``mu = 0.1 *
clip(g)``, so it is the gradient the optimizer applied), within 1e-4 * (max
|JAX leaf| + the step's largest |JAX gradient|) of JAX's reduced gradient
clipped at ``clipvalue``; after the adamax step every parameter within 1e-3
* lr where |JAX grad| >= 1e-4 and within 2 * lr everywhere; batch-norm
statistics <= 1e-5 of max(1, max |JAX statistic|). The eval step's losses:
1e-5 relative under sync-BN, 3e-5 with per-rank statistics of one image.
The two ranks' states are equal bit for bit after every step. A step over a
group of one rank is bit-equal to ``make_train_step``. With a non-finite
batch on one rank, every rank skips the update (the port's guard reads the
reduced loss; ROADMAP §C).
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from maskrcnn_tf2_tpu.config import MaskRCNNConfig as JaxConfig
from maskrcnn_tf2_tpu.ops.anchors import get_anchors as jax_get_anchors
from maskrcnn_tf2_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from maskrcnn_tf2_tpu.train.train_step import TrainState as JaxTrainState
from maskrcnn_tf2_tpu.train.train_step import _loss_and_updates, fused_pmean
from maskrcnn_tf2_tpu.train.train_step import make_data_parallel_eval_step, make_train_step as jax_make_train_step

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.parallel.multihost_dryrun import launch
from maskrcnn_tf2_tpu_torch.weights import flax_to_state_dict

import torch_port_dp_workers as workers
from test_torch_port_train_step import BASE, _SamplingKey, jax_variables, make_batch, port_state, rel

RANKS = 2
TIMEOUT = 400  # one launch runs every case here


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs six test processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def jax_draws(rng, cfg, num_rois, b):
    """The draws JAX's step makes from ``rng`` for ``b`` images
    (``test_torch_port_train_step.jax_draws`` at any batch)."""
    rng_sample, rng_rpn, _ = jax.random.split(rng, 3)
    sampling = _SamplingKey().apply({}, rngs={"sampling": rng_sample})
    out = {k: [] for k in ("rpn_pos", "rpn_neg", "det_pos", "det_neg")}
    for kind, keys, n in (("rpn", jax.random.split(rng_rpn, b), cfg.num_anchors()),
                          ("det", jax.random.split(sampling, b), num_rois)):
        for key in keys:
            kp, kn = jax.random.split(key)
            out[f"{kind}_pos"].append(np.asarray(jax.random.uniform(kp, (n,))))
            out[f"{kind}_neg"].append(np.asarray(jax.random.uniform(kn, (n,))))
    return {k: np.stack(v) for k, v in out.items()}


def dp_batch():
    """``make_batch``'s two images with their GT classes inside the 3-class
    configuration (its id 3 becomes 2)."""
    batch = make_batch()
    batch["gt_class_ids"] = np.minimum(batch["gt_class_ids"], 2)
    return batch


def rows(batch, i):
    return {k: np.asarray(v[i:i + 1]) for k, v in batch.items()}


def mesh2():
    return Mesh(np.asarray(jax.devices()[:RANKS]), ("data",))


def jax_dp_step(jcfg):
    """JAX's data-parallel step on a 2-device mesh, and its reduced gradients,
    in one program: ``(new_state, losses, grads)``."""
    anchors = jnp.asarray(jax_get_anchors(jcfg))
    step_fn = jax_make_train_step(jcfg, axis_name="data")

    def fn(state, batch, rng):
        new_state, losses = step_fn(state, batch, rng)
        shard_rng = jax.random.fold_in(rng, jax.lax.axis_index("data"))
        grad_fn = jax.grad(lambda p: _loss_and_updates(p, state.batch_stats, batch, shard_rng, jcfg, anchors,
                                                       True)[0])
        (grads,) = fused_pmean((grad_fn(state.params),), "data")
        return new_state, losses, grads

    from jax.experimental.shard_map import shard_map

    return jax.jit(shard_map(fn, mesh=mesh2(), in_specs=(P(), P("data"), P()), out_specs=(P(), P(), P()),
                             check_rep=False))


KEYS = {False: "per_rank_bn", True: "sync_bn"}
LEAF_SHAPES = [(3, 5), (7,), (), (2, 2, 4)]


def fused_leaves():
    rs = np.random.RandomState(3)
    return [[rs.normal(size=s).astype(np.float32) for s in LEAF_SHAPES] for _ in range(RANKS)]


@pytest.fixture(scope="module")
def run():
    """The port's two ranks (``workers.dp_all``) and JAX's references on the
    same inputs: ``(model, {sync_bn: JAX's outputs}, [rank outputs])``."""
    cfgs = {sync_bn: MaskRCNNConfig(**BASE, sync_bn=sync_bn) for sync_bn in KEYS}
    variables = jax_variables()
    batch, rng = dp_batch(), jax.random.PRNGKey(7)
    jcfg = JaxConfig(**BASE)
    n = cfgs[False].post_nms_rois_training
    draws = [jax_draws(jax.random.fold_in(rng, i), jcfg, n, 1) for i in range(RANKS)]
    eval_draws = [jax_draws(rng, jcfg, n, 1)] * RANKS  # the JAX eval step folds no axis index in
    model = port_state(cfgs[False], variables).model
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    one = (batch, jax_draws(rng, jcfg, n, 2))
    args = ({KEYS[k]: c.to_dict() for k, c in cfgs.items()}, sd, [rows(batch, i) for i in range(RANKS)], draws,
            eval_draws, fused_leaves(), one)
    with ThreadPoolExecutor(1) as pool:  # the port's ranks run while JAX compiles
        ranks = pool.submit(launch, workers.dp_all, RANKS, args, timeout_s=TIMEOUT)
        refs = {}
        for sync_bn in KEYS:
            jcfg = JaxConfig(**BASE, sync_bn=sync_bn)
            tx = jax_build_optimizer(jcfg)
            state = JaxTrainState(jnp.zeros((), jnp.int32), variables["params"], variables["batch_stats"],
                                  tx.init(variables["params"]))
            new_state, losses, grads = jax_dp_step(jcfg)(state, batch, rng)
            eval_losses = make_data_parallel_eval_step(jcfg, mesh2())(state, batch, rng)
            refs[sync_bn] = jax.tree.map(np.asarray, dict(losses=losses, grads=grads, params=new_state.params,
                                                          stats=new_state.batch_stats, eval=eval_losses))
        return model, refs, ranks.result()


@pytest.mark.parametrize("sync_bn", [False, True], ids=["per_rank_bn", "sync_bn"])
def test_data_parallel_step_matches_jax(sync_bn, run):
    model, refs, ranks = run
    ref, out = refs[sync_bn], ranks[0][KEYS[sync_bn]]
    assert float(ref["losses"]["mrcnn_mask_loss"]) > 0 and float(ref["losses"]["grad_finite"]) == 1.0
    lo = out["losses"][0]
    assert set(lo) == set(ref["losses"])
    for k, v in ref["losses"].items():
        assert rel(lo[k], v) <= 1e-5, k
    want = flax_to_state_dict({"params": ref["grads"]}, model, params_only=True)
    gmax = max(float(w.abs().max()) for w in want.values())
    jcfg = JaxConfig(**BASE)
    assert set(out["mu"]) == set(want)
    for name, mu in out["mu"].items():
        w = np.clip(want[name].numpy(), -jcfg.clipvalue, jcfg.clipvalue)
        g = mu / np.float32(1 - 0.9)  # adamax's b1; the moment starts at zero
        assert np.abs(g - w).max() <= 1e-4 * (np.abs(w).max() + gmax), name
    lr = jcfg.learning_rate
    sd = out["states"][0]
    new = flax_to_state_dict({"params": ref["params"], "batch_stats": ref["stats"]}, model)
    for name, _ in model.named_parameters():
        err, g = np.abs(sd[name] - new[name].numpy()), want[name].numpy()
        assert err.max() <= 2 * lr, name
        assert np.all(err[np.abs(g) >= 1e-4] <= 1e-3 * lr), name
    for name, w in new.items():
        if name.endswith(("running_mean", "running_var")):
            w = w.numpy()
            assert np.abs(sd[name] - w).max() <= 1e-5 * max(1.0, np.abs(w).max()), name


@pytest.mark.parametrize("sync_bn", [False, True], ids=["per_rank_bn", "sync_bn"])
def test_ranks_stay_bit_identical(sync_bn, run):
    out = [r[KEYS[sync_bn]] for r in run[2]]
    for step in range(2):
        a, b = out[0]["states"][step], out[1]["states"][step]
        assert all(np.array_equal(a[k], b[k]) for k in a), step
        assert all(np.array_equal(out[0]["losses"][step][k], out[1]["losses"][step][k]) for k in a and
                   out[0]["losses"][step])


@pytest.mark.parametrize("sync_bn,tol", [(False, 3e-5), (True, 1e-5)], ids=["per_rank_bn", "sync_bn"])
def test_data_parallel_eval_step_matches_jax(sync_bn, tol, run):
    """Both ranks return the mean losses. With per-rank statistics the
    heads' batch norms see one image's 8 ROIs, and the mask loss lands
    1.2e-5 apart: held at 3e-5 there, 1e-5 under sync-BN."""
    ref = run[1][sync_bn]
    for r in range(RANKS):
        out = run[2][r][KEYS[sync_bn]]
        assert set(out["eval"]) == set(ref["eval"])
        for k, v in ref["eval"].items():
            assert rel(out["eval"][k], v) <= tol, k


def test_fused_all_reduce_mean_matches_fused_pmean(run):
    """The same random pytree per shard: the port's buffer over 2 gloo ranks
    and JAX's ``fused_pmean`` over 2 virtual devices, equal bit for bit in
    float32."""
    from jax.experimental.shard_map import shard_map

    leaves = fused_leaves()
    stacked = [np.stack([leaves[r][i] for r in range(RANKS)]) for i in range(len(LEAF_SHAPES))]
    fn = shard_map(lambda *xs: fused_pmean(tuple(x[0] for x in xs), "data"), mesh=mesh2(),
                   in_specs=tuple(P("data") for _ in LEAF_SHAPES), out_specs=P(), check_rep=False)
    want = jax.tree.map(np.asarray, jax.jit(fn)(*stacked))
    for r in range(RANKS):
        for got, w in zip(run[2][r]["fused"], want):
            assert got.dtype == np.float32 and np.array_equal(got, w)


def test_world_size_one_is_bit_equal_to_make_train_step(run):
    equal = run[2][0]["world_one"]
    assert len(equal) > 100 and all(equal.values()), [k for k, v in equal.items() if not v]


def test_guard_skips_on_every_rank_when_one_rank_is_not_finite(run):
    """JAX's guard tests each shard's local total: the finite shard would
    apply the poisoned mean gradient while the other skips. The port's reads
    the reduced total: both ranks skip, and stay equal."""
    out = [r["guard"] for r in run[2]]
    for r in range(RANKS):
        assert float(out[r]["losses"]["grad_finite"]) == 0.0 and not np.isfinite(out[r]["losses"]["loss_sum"])
        assert out[r]["count"] == (0, 0) and out[r]["step"] == 1
        assert all(np.array_equal(out[r]["after"][k], v) for k, v in out[r]["before"].items())
        assert all(np.array_equal(out[r]["after"][k], out[0]["after"][k]) for k in out[r]["after"])
