"""The port's training loop and checkpoints, on the CPU.

``PlateauScheduler`` against the JAX package's: every LR equal on a fixed
metric sequence. Checkpoints: the model, the optimizer state, the step and
``extra`` restored exactly; best-only ranking, ``max_to_keep``,
``pick_resume_manager`` and a restore with nothing saved as the JAX
package's orbax managers behave. ``train_model`` on a tiny configuration
(ResNet-18, 64x64, 64-wide FPN/FC/mask head) equals the same steps driven by
hand on the same batches and generators, bit for bit; a run stopped after
epoch 1 and resumed equals the unbroken run bit for bit; the SIGTERM drill
leaves a preemption checkpoint (and a profiler trace of its one step) and
resumes to the end; the SIGTERM handler is restored when training raises.
"""

import os
import signal

import pytest
import torch

from maskrcnn_tf2_tpu.train.loop import PlateauScheduler as JaxPlateauScheduler

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.data.loader import DataLoader
from maskrcnn_tf2_tpu_torch.data.synthetic import SyntheticShapesDataset
from maskrcnn_tf2_tpu_torch.train import checkpoint as ckpt_lib
from maskrcnn_tf2_tpu_torch.train.loop import PlateauScheduler, step_generator, train_model
from maskrcnn_tf2_tpu_torch.train.train_step import create_train_state, make_train_step

TINY = dict(image_shape=(64, 64, 3), image_min_dim=64, image_max_dim=64, rpn_anchor_scales=(8, 16, 24, 32, 48),
            pre_nms_limit=128, post_nms_rois_training=32, post_nms_rois_inference=32, train_rois_per_image=8,
            max_gt_instances=4, mini_mask_shape=(28, 28), num_classes=4, backbone="resnet18",
            top_down_pyramid_size=64, fpn_cls_fc_layers_size=64, mask_conv_channels=64, compute_dtype="float32",
            batch_size=2, epochs=2, log_per_steps=1, augment_on_device=True, augment_scale_jitter=0.25,
            augment_photometric=0.2)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs six test processes on the
    machine's cores, and more threads per process only contend."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def shapes(n, seed):
    ds = SyntheticShapesDataset()
    ds.load_shapes(n, 64, 64, seed=seed)
    ds.prepare()
    return ds


@pytest.fixture(scope="module")
def data():
    return shapes(5, 1), shapes(2, 2)


def config(tmp_path, **over):
    return MaskRCNNConfig(**dict(TINY, checkpoints_dir=str(tmp_path), **over))


def assert_same_state(a, b):
    assert a.step == b.step
    for (k, v), w in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(v, w), k
    assert a.opt_state.count == b.opt_state.count and a.opt_state.hyperparams == b.opt_state.hyperparams
    for k, vs in a.opt_state.slots.items():
        assert all(torch.equal(x, y) for x, y in zip(vs, b.opt_state.slots[k])), k


# ---------------------------------------------------------------------------
# scheduler, checkpoints
# ---------------------------------------------------------------------------


def test_plateau_scheduler_matches_jax():
    metrics = [5.0, 4.0, 4.0, 4.5, 3.9999999, 4.2, 3.0, 3.1, 3.2, 3.3, 2.0, 2.0, 2.5]
    ours, ref = PlateauScheduler(0.5, 2, 1e-3), JaxPlateauScheduler(0.5, 2, 1e-3)
    lrs = [(ours.update(m), ref.update(m)) for m in metrics]
    assert all(a == b for a, b in lrs) and lrs[-1][0] < 1e-3 / 4
    assert ours.state_dict() == ref.state_dict()
    again = PlateauScheduler(0.5, 2, 1e-3)
    again.load_state_dict(ours.state_dict())
    assert [again.update(m) for m in metrics] == [ref.update(m) for m in metrics]


@pytest.fixture(scope="module")
def trained_state(data):
    """A tiny state after one step: a non-trivial optimizer state."""
    cfg = MaskRCNNConfig(**TINY)
    state = create_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = next(DataLoader(data[0], cfg, seed=0).epoch())
    state, _ = make_train_step(cfg)(state, {k: torch.from_numpy(v) for k, v in batch.items()}, rng=step_generator(0, 0))
    return cfg, state


def test_checkpoint_round_trip(tmp_path, trained_state):
    cfg, state = trained_state
    manager = ckpt_lib.make_manager(cfg, str(tmp_path))
    extra = {"lr": 5e-4, "best": 1.25, "bad_epochs": 3.0}
    ckpt_lib.save(manager, state, epoch=4, metrics={"loss_sum": 1.5}, extra=extra)
    fresh = create_train_state(cfg, torch.Generator().manual_seed(1), device="cpu")
    # a fresh manager reads the index back, as a resumed process does
    restored, start, got = ckpt_lib.restore(ckpt_lib.make_manager(cfg, str(tmp_path)), fresh, extra_template=extra)
    assert start == 5 and got == extra
    assert_same_state(restored, state)
    _, _, none = ckpt_lib.restore(manager, fresh)  # no template: no extra
    assert none is None
    assert os.path.basename(ckpt_lib.checkpoint_dir(cfg, str(tmp_path))) == f"maskrcnn_resnet18_{cfg.md5()[:8]}"


def test_restore_without_checkpoint_is_noop(tmp_path, trained_state):
    cfg, state = trained_state
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    out, start, extra = ckpt_lib.restore(ckpt_lib.make_manager(cfg, str(tmp_path)), state, extra_template={"lr": 1.0})
    assert out is state and start == 0 and extra is None
    assert all(torch.equal(v, before[k]) for k, v in state.model.state_dict().items())


@pytest.mark.parametrize("best_only", [True, False])
def test_best_only_ranking_and_max_to_keep(tmp_path, trained_state, best_only):
    cfg, state = trained_state
    cfg = cfg.replace(save_best_only=best_only)
    manager = ckpt_lib.make_manager(cfg, str(tmp_path), max_to_keep=2)
    losses = [3.0, 1.0, 2.0, 4.0, 1.5]
    for epoch, loss in enumerate(losses):  # val_loss_sum ranks over loss_sum
        ckpt_lib.save(manager, state, epoch, {"loss_sum": 0.0, "val_loss_sum": loss})
    kept = [1, 4] if best_only else [3, 4]
    assert manager.all_steps() == kept and manager.latest_step() == 4
    files = sorted(f for f in os.listdir(manager.directory) if f.endswith(".pt"))
    assert files == [f"ckpt_{k}.pt" for k in kept]
    assert ckpt_lib.make_manager(cfg, str(tmp_path), max_to_keep=2).all_steps() == kept


def test_pick_resume_manager(tmp_path, trained_state):
    cfg, state = trained_state
    main, pre = ckpt_lib.make_manager(cfg, str(tmp_path)), ckpt_lib.make_preempt_manager(cfg, str(tmp_path))
    assert ckpt_lib.pick_resume_manager(main, pre) is main  # nothing saved
    ckpt_lib.save(pre, state, 0, {"loss_sum": 9.0})
    assert ckpt_lib.pick_resume_manager(main, pre) is pre
    ckpt_lib.save(main, state, 0, {"loss_sum": 1.0})
    assert ckpt_lib.pick_resume_manager(main, pre) is main  # a tie goes to the whole epoch
    ckpt_lib.save(pre, state, 1, {"loss_sum": 9.0})
    assert ckpt_lib.pick_resume_manager(main, pre) is pre and pre.all_steps() == [1]


# ---------------------------------------------------------------------------
# train_model
# ---------------------------------------------------------------------------


def test_train_model_equals_steps_by_hand(tmp_path, data):
    train, _ = data
    cfg = config(tmp_path, sample_cache_dir=str(tmp_path / "cache"))
    logged = []
    state = train_model(cfg, train, device="cpu", metric_writer=lambda s, m: logged.append(s))
    assert state.step == 4 and logged == [1, 2, 3, 4]

    by_hand = create_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    step = make_train_step(cfg)
    loader = DataLoader(train, cfg.replace(sample_cache_dir=None), shuffle=True)
    for epoch in range(2):
        for batch in loader.epoch():
            by_hand, _ = step(by_hand, {k: torch.from_numpy(v) for k, v in batch.items()},
                              rng=step_generator(0, by_hand.step))
        if epoch == 0:  # the plateau's first update leaves the rate as it is
            assert by_hand.opt_state.hyperparams["learning_rate"] == cfg.learning_rate
    assert_same_state(state, by_hand)


class Stop(Exception):
    pass


def test_resume_after_epoch_1_equals_the_unbroken_run(tmp_path, data):
    train, val = data
    cfg = config(tmp_path, reduce_lr_patience=1, reduce_lr_factor=0.5)
    history = []
    unbroken = train_model(cfg, train, val, device="cpu", checkpoint_base=str(tmp_path / "a"), history=history)

    def crash(step, losses):
        if step == 3:  # the first step of epoch 2
            raise Stop

    with pytest.raises(Stop):
        train_model(cfg, train, val, device="cpu", checkpoint_base=str(tmp_path / "b"), metric_writer=crash)
    manager = ckpt_lib.make_manager(cfg, str(tmp_path / "b"))
    assert manager.all_steps() == [0]
    resumed_history = []
    resumed = train_model(cfg, train, val, device="cpu", checkpoint_base=str(tmp_path / "b"),
                          history=resumed_history)
    assert_same_state(resumed, unbroken)
    # the same epoch metrics, LR and plateau state as the unbroken run's epoch 2
    timing = ("seconds", "images_per_s", "train_seconds", "loader_wait_s")
    assert len(history) == 2 and len(resumed_history) == 1 and "val_loss_sum" in history[1]
    assert {k: v for k, v in resumed_history[0].items() if k not in timing} == {
        k: v for k, v in history[1].items() if k not in timing}
    extras = [ckpt_lib.make_manager(cfg, str(tmp_path / d)).restore(1, "cpu")["extra"] for d in "ab"]
    assert extras[0] == extras[1]


def test_sigterm_drill_checkpoints_and_resumes(tmp_path, data):
    train, val = data
    cfg = config(tmp_path)
    fired = []

    def send_sigterm(step, losses):
        if not fired:  # the first step of epoch 1
            os.kill(os.getpid(), signal.SIGTERM)
        fired.append(step)

    prev = signal.getsignal(signal.SIGTERM)
    state = train_model(cfg, train, val, device="cpu", metric_writer=send_sigterm, profile_steps=(0, 0))
    assert state.step == 1 and fired == [1]
    assert os.path.exists(os.path.join(ckpt_lib.checkpoint_dir(cfg), "trace_steps_0_0.json"))
    assert signal.getsignal(signal.SIGTERM) is prev
    manager, pre = ckpt_lib.make_manager(cfg), ckpt_lib.make_preempt_manager(cfg)
    assert manager.latest_step() is None and pre.all_steps() == [0]
    assert ckpt_lib.pick_resume_manager(manager, pre) is pre
    state = train_model(cfg, train, val, device="cpu")  # resumes at epoch 2, runs to the end
    assert state.step == 3
    manager = ckpt_lib.make_manager(cfg)
    assert manager.all_steps() == [1] and "val_loss_sum" in manager.metrics(1)
    assert ckpt_lib.pick_resume_manager(manager, ckpt_lib.make_preempt_manager(cfg)) is manager


def test_handlers_restored_when_training_raises(tmp_path, data):
    def boom(step, losses):
        raise Stop

    prev = signal.getsignal(signal.SIGTERM)
    with pytest.raises(Stop):
        train_model(config(tmp_path), data[0], device="cpu", metric_writer=boom)
    assert signal.getsignal(signal.SIGTERM) is prev
