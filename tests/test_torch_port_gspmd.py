"""The port's tensor parallelism (``parallel/gspmd.py``) against the JAX
package's gspmd steps, on the CPU.

Four gloo ranks (``parallel.multihost_dryrun.launch``, the functions in
``tests/torch_port_tp_workers.py``) run the port: the world as a DP2xTP2
mesh, one image a data rank, and ranks 0 and 1 also as a DP1xTP2 mesh. The
JAX package runs ``make_gspmd_train_step`` on ``make_mesh_2d(1, 2)`` and
``(2, 2)`` of the conftest's virtual CPU devices, and its eval step, while
the ranks run. Both get the same bridged weights, the same batch and the same
draws: JAX's global-batch draws, split by data rank. The configuration is
``test_torch_port_parallel``'s scene (``test_torch_port_train_step``'s tiny
float32 ResNet-18 at 64 px, FC 128, 3 classes, the batch with its GT
classes in range) in gspmd mode with ``tp_shards=2``: its tolerances are
calibrated on that scene, and the layout, not the backbone, is under test.

Two settings of the batch norms. On their running averages
(``train_bn=False``) the step's gradients are well conditioned in this scene
(``test_torch_port_train_step::test_gradients_match_jax_on_running_averages``),
and DP1xTP2 and DP2xTP2 are held against JAX with the rules of
``test_torch_port_parallel`` (its docstring says why): each loss of the
first step within 1e-5 relative, ``l2_loss`` within 1e-6; the first adamax
moments of the gathered whole state within 1e-4 * (max |JAX leaf| + the
step's largest |JAX moment|); the parameters within 1e-3 * lr where |JAX
grad| >= 1e-4 and 2 * lr everywhere. On batch statistics (DP2xTP2, the
global batch's statistics over the data group) the same moments and
parameters, and the running statistics within 1e-5 of max(1, max |JAX
statistic|); the losses within 3e-5, the tolerance ``test_torch_port_parallel``
gives losses behind batch norms over few ROIs: there the heads' batch norms
see 16 ROIs split 8 + 8 over the data ranks, ``mrcnn_bbox_loss`` lands
1.19e-5 from JAX's gspmd step, and JAX's own gspmd and single-device steps
differ by 3.5e-6 there. (On batch statistics the one-process port itself
exceeds the moment rule at one or two intra-op threads on the first
mask-head conv, 1.08 of its budget, so that comparison is made on running
averages.) JAX's own gspmd step is not one reference on running averages:
on the (2, 2) mesh the first moment of ``backbone.stage3_block1.conv1``'s
kernel lands 8.05 budgets from the (1, 2) mesh's (the same global-batch
program), while the port's DP2xTP2 moments lie within 0.04 budgets of the
(1, 2) mesh's and DP1xTP2's within 0.015. So on running averages both port
layouts' updates (and clipnorm's) are held against JAX's (1, 2) mesh, their
losses against their own mesh. ``tests/torch_port_conditioning.py`` (section
3) prints each of these numbers.

Replicated leaves are bit-equal on every rank after every step, a shard on
its data group. The topology change of the JAX package's
``tests/test_elastic_checkpoint.py``: a DP2xTP2 checkpoint restored onto
DP1xTP2 and into one process, bit-equal to what was saved, and its next
step's losses within that test's ``rtol=2e-4, atol=2e-5`` of the native
topology's; the same after placing the one-process state back onto DP2xTP2.
"""

import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jit_fast import FAST_COMPILE

from maskrcnn_tf2_tpu.config import MaskRCNNConfig as JaxConfig
from maskrcnn_tf2_tpu.parallel.gspmd import make_gspmd_eval_step as jax_gspmd_eval_step
from maskrcnn_tf2_tpu.parallel.gspmd import make_gspmd_train_step as jax_gspmd_train_step
from maskrcnn_tf2_tpu.parallel.gspmd import make_mesh_2d as jax_mesh_2d
from maskrcnn_tf2_tpu.parallel.gspmd import place_state as jax_place_state
from maskrcnn_tf2_tpu.parallel.gspmd import shard_global_batch as jax_shard_global_batch
from maskrcnn_tf2_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from maskrcnn_tf2_tpu.train.train_step import TrainState as JaxTrainState

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.models.heads import FPNClassifierHead
from maskrcnn_tf2_tpu_torch.parallel.mesh import Mesh2D
from maskrcnn_tf2_tpu_torch.parallel.multihost_dryrun import launch, tiny_config
from maskrcnn_tf2_tpu_torch.weights import flax_to_state_dict

import torch_port_tp_workers as workers
from test_torch_port_parallel import dp_batch, jax_draws
from test_torch_port_train_step import BASE, jax_variables, port_state, rel

RANKS = 4
TIMEOUT = 400  # one launch runs every case here
TP_BN = dict(BASE, parallel_mode="gspmd", tp_shards=2, batch_size=2)
TP = dict(TP_BN, train_bn=False, train_bn_backbone=False)
CLIPNORM = 1e-3  # below the first step's gradient norm: the clip binds
FC, POOLED = BASE["fpn_cls_fc_layers_size"], 7 * 7 * BASE["top_down_pyramid_size"]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs six test processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def find_mu(opt_state):
    """The first moment of the adamax state in an optax state tree."""
    return next(n.mu for n in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu"))
                if hasattr(n, "mu"))


def jax_state(jcfg, variables):
    tx = jax_build_optimizer(jcfg)
    return JaxTrainState(jnp.zeros((), jnp.int32), variables["params"], variables["batch_stats"],
                         tx.init(variables["params"]))


def jax_gspmd(jcfg, variables, batch, rng, n_data, extras=False):
    """Two steps of JAX's gspmd step on a ``(n_data, 2)`` mesh from the
    bridged weights, with the same key: the first step's state, losses and
    adamax moments, the second's losses, and (``extras``) the eval step's
    losses and ``place_state``'s per-device slices of the classifier."""
    mesh = jax_mesh_2d(n_data, 2, jcfg.mesh_data_axis, jcfg.mesh_model_axis)
    state0 = jax_state(jcfg, variables)
    jstep, placed = jax_gspmd_train_step(jcfg, mesh, state0, compiler_options=FAST_COMPILE)
    sharded = jax_shard_global_batch(batch, mesh, jcfg)
    s1, l1 = jstep(placed, sharded, rng)
    _, l2 = jstep(s1, sharded, rng)
    out = dict(losses=[l1, l2], params=s1.params, stats=s1.batch_stats, mu=find_mu(s1.opt_state))
    if extras:
        out["eval"] = jax_gspmd_eval_step(jcfg, mesh, state0, compiler_options=FAST_COMPILE)(placed, sharded, rng)
        laid = jax_place_state(state0, mesh, jcfg)
        out["slices"] = [{coll: jax.tree.map(lambda a: np.asarray(next(s.data for s in a.addressable_shards
                                                                       if s.device == mesh.devices[0, m])),
                                             getattr(laid, coll)["classifier"])
                          for coll in ("params", "batch_stats")} for m in range(2)]
    return jax.tree.map(np.asarray, out)


@pytest.fixture(scope="module")
def run():
    """The four ranks (``workers.tp_all``) and JAX's references on the same
    inputs: ``(model, {case: JAX's outputs}, clipnorm reference, [rank
    outputs])``, the cases ``dp1``, ``dp2`` (running averages) and
    ``dp2_bn`` (batch statistics)."""
    variables = jax_variables()
    batch, rng = dp_batch(), jax.random.PRNGKey(7)
    jcfg = JaxConfig(**TP)
    draws = jax_draws(rng, jcfg, TP["post_nms_rois_training"], 2)
    model = port_state(MaskRCNNConfig(**TP), variables).model
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    configs = {"tp": TP, "tp_bn": TP_BN, "clipnorm": dict(TP, clipnorm=CLIPNORM),
               "loop": tiny_config(batch_size=2, epochs=1, parallel_mode="gspmd", tp_shards=2).to_dict()}
    with tempfile.TemporaryDirectory() as root, ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch, workers.tp_all, RANKS, (configs, sd, batch, draws, draws, root),
                            timeout_s=TIMEOUT, num_threads=1)
        refs = {"dp1": jax_gspmd(jcfg, variables, batch, rng, 1),
                "dp2": jax_gspmd(jcfg, variables, batch, rng, 2, extras=True),
                "dp2_bn": jax_gspmd(JaxConfig(**TP_BN), variables, batch, rng, 2)}
        # clipnorm's reference: the first step's gradients (clipped at
        # clipvalue, read from JAX's moments) through the clipnorm chain
        ccfg = JaxConfig(**TP, clipnorm=CLIPNORM)
        tx = jax_build_optimizer(ccfg)
        grads = jax.tree.map(lambda m: jnp.asarray(m) / np.float32(0.1), refs["dp1"]["mu"])
        _, st = tx.update(grads, tx.init(variables["params"]), variables["params"])
        clip_mu = jax.tree.map(np.asarray, find_mu(st))
        return model, refs, clip_mu, ranks.result()


def moments_match(model, mu, port_mu):
    want = flax_to_state_dict({"params": mu}, model, params_only=True)
    mu_max = max(float(w.abs().max()) for w in want.values())
    assert set(port_mu) == set(want)
    for name, m in port_mu.items():
        w = want[name].numpy()
        assert np.abs(m - w).max() <= 1e-4 * (np.abs(w).max() + mu_max), name
    return want


CASES = {"dp1": 1, "dp2": 2, "dp2_bn": 2}


@pytest.mark.parametrize("case", list(CASES))
def test_gspmd_step_matches_jax(case, run):
    """DP1xTP2 and DP2xTP2 on running averages, DP2xTP2 on batch statistics."""
    model, refs, _, ranks = run
    ref, out = refs[case], ranks[0][case]
    assert float(ref["losses"][0]["mrcnn_mask_loss"]) > 0 and float(ref["losses"][0]["grad_finite"]) == 1.0
    lo = out["losses"][0]
    assert set(lo) == set(ref["losses"][0])
    for k, v in ref["losses"][0].items():
        assert rel(lo[k], v) <= (1e-6 if k == "l2_loss" else 3e-5 if case == "dp2_bn" else 1e-5), k
    # on running averages JAX's (2, 2) program moves one leaf's gradient
    # 8x the budget from its own (1, 2) program: the update is held
    # against the latter, the same global-batch program (module docstring)
    ref = refs["dp1"] if case == "dp2" else ref
    want = moments_match(model, ref["mu"], out["mu"])
    lr = JaxConfig(**TP).learning_rate
    new = flax_to_state_dict({"params": ref["params"], "batch_stats": ref["stats"]}, model)
    whole = out["whole"]
    for name, _ in model.named_parameters():
        err, g = np.abs(whole[name] - new[name].numpy()), want[name].numpy() / np.float32(0.1)
        assert err.max() <= 2 * lr, name
        assert np.all(err[np.abs(g) >= 1e-4] <= 1e-3 * lr), name
    moved = 0
    for name, w in new.items():
        if name.endswith(("running_mean", "running_var")):
            w = w.numpy()
            assert np.abs(whole[name] - w).max() <= 1e-5 * max(1.0, np.abs(w).max()), name
            moved += not np.array_equal(w, model.state_dict()[name].numpy())
    assert (moved > 0) == (case == "dp2_bn")


@pytest.mark.parametrize("case", list(CASES))
def test_replicated_leaves_and_shards_stay_bit_identical(case, run):
    """Replicated leaves equal on every rank after every step, each shard on
    its data group, every model rank's losses the same, and the head's
    leaves of the shards' shapes."""
    ranks = [r for r in run[3] if case in r]
    assert len(ranks) == 2 * CASES[case]
    for step in range(2):
        repl = [r[case]["sums"][step][0] for r in ranks]
        assert all(np.array_equal(repl[0], c) for c in repl)
        for m in range(2):
            shard = [r[case]["sums"][step][1] for r in ranks if r["coords"][1] == m]
            assert all(np.array_equal(shard[0], c) for c in shard)
        assert not np.array_equal(ranks[0][case]["sums"][step][1], ranks[1][case]["sums"][step][1])
        for r in ranks:
            assert all(np.array_equal(v, ranks[0][case]["losses"][step][key])
                       for key, v in r[case]["losses"][step].items())
    for r in ranks:
        shapes = r[case]["shapes"]
        assert shapes["mrcnn_class_conv1.weight"] == (FC // 2, POOLED)
        assert shapes["mrcnn_class_conv1.bias"] == shapes["mrcnn_class_bn1.running_var"] == (FC // 2,)
        assert shapes["mrcnn_class_conv2.weight"] == (FC, FC // 2)
        assert shapes["mrcnn_class_conv2.bias"] == (FC,)


@pytest.mark.parametrize("case", ["dp1", "dp2"])
def test_gspmd_eval_step_matches_jax(case, run):
    ref = run[1]["dp2"]["eval"]
    for r in run[3]:
        if case in r:
            out = r[case]["eval"]
            assert set(out) == set(ref)
            for k, v in ref.items():
                assert rel(out[k], v) <= 1e-5, k


def test_clipnorm_counts_each_shard_once(run):
    """``clipnorm`` binds (the norm is ~1e3 times the threshold): the
    moments of the clipped step match JAX's chain on the same gradients."""
    model, _, clip_mu, ranks = run
    moments_match(model, clip_mu, ranks[0]["clipnorm"]["mu"])


def test_guard_skips_on_every_rank(run):
    for r in run[3]:
        g = r["guard"]
        assert g["unchanged"] and g["count"] == 0 and float(g["losses"]["grad_finite"]) == 0.0


def test_place_state_slices_match_jax_and_gather_restores_the_bits(run):
    """Each rank's shards are the slices JAX's ``place_state`` gives its
    devices, after the ``[in, out] -> [out, in]`` transpose; gathering a
    placed state gives back the whole state's bits (its seeded optimizer
    slots included)."""
    _, refs, _, ranks = run
    for r in ranks:
        m = r["coords"][1]
        head = FPNClassifierHead(BASE["top_down_pyramid_size"], BASE["num_classes"], 7, FC,
                                 tp=Mesh2D(None, None, None, 2, 2, 0, m))
        want = flax_to_state_dict(refs["dp2"]["slices"][m], head)
        got = r["place"]["shards"]
        assert set(got) == {f"classifier.{k}" for k in ("mrcnn_class_conv1.weight", "mrcnn_class_conv1.bias",
                                                          "mrcnn_class_bn1.weight", "mrcnn_class_bn1.bias",
                                                          "mrcnn_class_bn1.running_mean",
                                                          "mrcnn_class_bn1.running_var",
                                                          "mrcnn_class_conv2.weight")}
        for name, v in got.items():
            assert np.array_equal(v, want[name[len("classifier."):]].numpy()), name
        n_equal, n = r["place"]["equal"]
        assert n > 200 and n_equal == n


def test_tensor_parallel_operators_against_one_process(run):
    """``copy_to_model_group`` / ``reduce_from_model_group`` give every
    gradient of a whole two-layer FC (within 1e-6); ``_AllReduceSum`` as the
    exit would double the cotangent of everything before it."""
    for r in run[3]:
        for name, (whole, tp, naive) in r["ops"].items():
            np.testing.assert_allclose(tp, whole, rtol=1e-6, atol=1e-6, err_msg=name)
            if name != "b2":
                np.testing.assert_allclose(naive, 2 * whole, rtol=1e-6, atol=1e-6, err_msg=name)


def test_topology_change_restore(run):
    """DP2xTP2 on batch statistics saved after one step; restored onto
    DP1xTP2, into one process, and from one process placed back onto
    DP2xTP2."""
    ranks = run[3]
    native = ranks[0]["dp2_bn"]["losses"][1]
    for r, key in [(ranks[0], "restore_dp1"), (ranks[1], "restore_dp1"), (ranks[2], "restore_one")]:
        out = r[key]
        n_equal, n = out["equal"]
        assert n > 200 and n_equal == n and out["start"] == 1 and out["step"] == 2, key
        for k, v in native.items():
            np.testing.assert_allclose(out["losses"][k], v, rtol=2e-4, atol=2e-5, err_msg=k)
    for r in ranks:
        for k, v in native.items():
            np.testing.assert_allclose(r["placed_back"][k], v, rtol=2e-4, atol=2e-5, err_msg=k)


def test_train_model_in_gspmd_mode(run):
    """``train_model`` over the four ranks: a (2, 2) layout, the loader and
    draws by data rank, rank 0 alone writes, and the checkpoint is whole."""
    cfg = tiny_config(batch_size=2, parallel_mode="gspmd", tp_shards=2)
    fc, pooled = cfg.fpn_cls_fc_layers_size, 7 * 7 * cfg.top_down_pyramid_size
    for r in run[3]:
        lp = r["loop"]
        assert lp["step"] == 2 and lp["data_rank"] == r["coords"][0]
        assert lp["writes"] == ([0] if r["rank"] == 0 else [])
        assert lp["shapes"]["mrcnn_class_conv1.weight"] == (fc // 2, pooled)
        assert lp["saved"]["classifier.mrcnn_class_conv1.weight"] == (fc, pooled)
        assert lp["saved"]["classifier.mrcnn_class_conv2.weight"] == (fc, fc)
        assert (fc, pooled) in lp["slots"]["mu"]


@pytest.mark.parametrize("over", [dict(parallel_mode="gspmd"), dict(parallel_mode="gspmd", tp_shards=2),
                                  dict(parallel_mode="gspmd", tp_shards=4), dict(tp_shards=2),
                                  dict(parallel_mode="gspmd", tp_shards=3), dict(parallel_mode="fsdp"),
                                  dict(tp_shards=0)])
def test_config_accepts_what_jax_accepts(over):
    """``parallel_mode`` and ``tp_shards`` are accepted exactly where the JAX
    package's config accepts them (FC 128: 3 shards do not divide it)."""
    try:
        JaxConfig(**BASE, **over)
        jax_ok = True
    except AssertionError:
        jax_ok = False
    if jax_ok:
        assert MaskRCNNConfig(**BASE, **over).tp_shards == over.get("tp_shards", 1)
    else:
        with pytest.raises(ValueError):
            MaskRCNNConfig(**BASE, **over)


def test_gspmd_step_refuses_sync_bn():
    """As JAX's ``make_gspmd_train_step`` asserts: the gspmd mode takes
    global-batch statistics by construction."""
    from maskrcnn_tf2_tpu_torch.parallel import gspmd

    cfg = MaskRCNNConfig(**TP_BN, sync_bn=True)
    mesh = Mesh2D(None, None, None, 1, 2, 0, 0)
    with pytest.raises(ValueError, match="sync_bn"):
        gspmd.make_gspmd_train_step(cfg, mesh, None)
