"""The port's multi-process wiring, on the CPU; mirrors ``tests/test_multihost.py``.

In process: ``host_shard`` partitions an order; the loader's shards are
disjoint and cover the dataset, and step for step the union of the shards'
samples is the single-process batch bit for bit; ``fixed_steps`` fills its
count. Across spawned gloo ranks (``parallel.multihost_dryrun.launch``, every
wait bounded): the dryrun (ownership counted by an all-reduce, the closed
form, a data-parallel step of the tiny model), the preemption drill (SIGTERM
to rank 1: every rank stops after the same step, one preemption checkpoint,
the resume completes), ``train_model`` under two ranks for two epochs (only
the primary writes checkpoints; a resume at the epoch boundary is bit-equal
to the unbroken run; the ranks end replicated) and ``cli.coco_train
--sync_bn --device cpu`` under two ranks.
"""

import numpy as np
import pytest
import torch

from maskrcnn_tf2_tpu.parallel.distributed import host_shard as jax_host_shard

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.data.loader import DataLoader
from maskrcnn_tf2_tpu_torch.data.synthetic import SyntheticShapesDataset
from maskrcnn_tf2_tpu_torch.parallel import multihost_dryrun
from maskrcnn_tf2_tpu_torch.parallel.distributed import host_shard
from maskrcnn_tf2_tpu_torch.train.synthetic import shapes_coco_datasets

import torch_port_dp_workers as workers
from test_torch_port_serving import TINY_WIDTHS

TIMEOUT = 240


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs six test processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_host_shard_partitions_order():
    order = np.random.RandomState(0).permutation(101)
    shards = [host_shard(order, i, 4) for i in range(4)]
    joined = np.concatenate(shards)
    assert sorted(joined.tolist()) == sorted(order.tolist())
    assert max(map(len, shards)) - min(map(len, shards)) <= 1
    for i in range(4):
        np.testing.assert_array_equal(shards[i], jax_host_shard(order, i, 4))


def test_initialize_is_a_no_op_alone_and_nccl_takes_a_card_a_rank(monkeypatch):
    from maskrcnn_tf2_tpu_torch.parallel import distributed

    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    assert distributed.initialize() is None and not distributed.is_initialized()
    assert distributed.rank() == 0 and distributed.world_size() == 1 and distributed.is_primary()
    with pytest.raises(ValueError, match="rank"):
        distributed.initialize(world_size=2)
    distributed.check_nccl_devices(2, 2)
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        distributed.check_nccl_devices(2, 1)


def loader_config(batch_size):
    return MaskRCNNConfig(image_shape=(64, 64, 3), image_min_dim=64, image_max_dim=64, batch_size=batch_size,
                          max_gt_instances=4, num_classes=4, random_rois=0)


def shapes(n, seed=2):
    ds = SyntheticShapesDataset()
    ds.load_shapes(n, 64, 64, seed=seed)
    ds.prepare()
    return ds


@pytest.mark.parametrize("count", [2, 4])
def test_loader_shards_union_is_the_single_process_batch(count):
    ds, cfg = shapes(16), loader_config(4)
    single = DataLoader(ds, cfg, seed=7)
    shards = [DataLoader(ds, cfg, seed=7, process_index=i, process_count=count) for i in range(count)]
    assert shards[0].batch_size == 4 // count and shards[0].steps_per_epoch == single.steps_per_epoch == 4
    for epoch in range(2):  # a second epoch: a new shuffle, the same rule
        order = np.arange(len(ds))
        np.random.RandomState(7).shuffle(order)
        owned = [set(host_shard(order, i, count).tolist()) for i in range(count)]
        assert set.union(*owned) == set(range(len(ds))) and sum(map(len, owned)) == len(ds)
        want = list(single.epoch(num_workers=2))
        got = [list(s.epoch(num_workers=2)) for s in shards]
        assert len(want) == 4 and all(len(g) == 4 for g in got)
        for step, batch in enumerate(want):
            for k, v in batch.items():
                # rank r's row i holds the sample at the step's global position r + count * i
                union = np.stack([got[r][step][k][i] for i in range(4 // count) for r in range(count)])
                np.testing.assert_array_equal(union, v, err_msg=f"epoch {epoch} step {step} {k}")


def test_fixed_steps_fills_the_count_on_every_shard():
    ds, cfg = shapes(10), loader_config(4)
    for i in range(2):
        loader = DataLoader(ds, cfg, seed=1, process_index=i, process_count=2)
        assert loader.steps_per_epoch == 2
        batches = list(loader.epoch(num_workers=2, fixed_steps=7))  # cycles its 5 images
        assert len(batches) == 7 and all(b["images"].shape[0] == 2 for b in batches)
    with pytest.raises(ValueError, match="split"):
        DataLoader(ds, loader_config(3), process_index=0, process_count=2)


def test_two_process_dryrun():
    out = multihost_dryrun.launch(multihost_dryrun.worker, 2, (True,), timeout_s=TIMEOUT)
    assert [o["owned"] for o in out] == [32, 32]
    assert out[0]["loss_sum"] == out[1]["loss_sum"] and np.isfinite(out[0]["loss_sum"])


def test_two_process_preemption_drill(tmp_path):
    out = multihost_dryrun.launch(multihost_dryrun.preempt_worker, 2, (str(tmp_path),), timeout_s=TIMEOUT)
    assert out[0]["stopped"] == out[1]["stopped"] >= 2
    assert out[0]["resumed"] == out[1]["resumed"] == out[0]["stopped"] + 4


def test_launcher_fails_and_stops_every_rank_when_one_rank_fails():
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        multihost_dryrun.launch(workers.fail_on_rank_one, 2, timeout_s=60)
    with pytest.raises(TimeoutError):
        multihost_dryrun.launch(workers.hang_on_rank_one, 2, timeout_s=6)


def test_train_model_under_two_ranks_resumes_bit_equal(tmp_path):
    """Two epochs under two ranks with sync-BN; then a job restarted from the
    epoch-0 checkpoint alone (copied to a fresh directory) trains epoch 1
    again and ends where the unbroken run ended, bit for bit."""
    from maskrcnn_tf2_tpu_torch.train import checkpoint as ckpt_lib

    cfg = multihost_dryrun.tiny_config(batch_size=2, epochs=2, sync_bn=True, max_gt_instances=4)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    whole = multihost_dryrun.launch(workers.train_run, 2, (cfg.to_dict(), a, False), timeout_s=TIMEOUT)
    first = ckpt_lib.make_manager(cfg, a)
    ckpt_lib.make_manager(cfg, b).save(0, first.restore(0, "cpu"), first.metrics(0))
    resumed = multihost_dryrun.launch(workers.train_run, 2, (cfg.to_dict(), b, True), timeout_s=TIMEOUT)
    for run, epochs in ((whole, [0, 1]), (resumed, [1])):
        assert run[0]["step"] == run[1]["step"] == 8  # 2 epochs of 4 global steps
        assert run[0]["writes"] == epochs and run[1]["writes"] == []  # the primary alone writes
        assert all(np.array_equal(run[0]["state"][k], v) for k, v in run[1]["state"].items())
        assert [h["steps"] for h in run[0]["history"]] == [4] * len(epochs)
        assert all(np.isfinite(h["val_loss_sum"]) for h in run[0]["history"])
    assert all(np.array_equal(resumed[0]["state"][k], v) for k, v in whole[0]["state"].items())
    timing = ("seconds", "images_per_s", "train_seconds", "loader_wait_s")
    assert {k: v for k, v in resumed[0]["history"][0].items() if k not in timing} == {
        k: v for k, v in whole[0]["history"][1].items() if k not in timing}


def test_cli_trains_under_two_ranks_with_sync_bn(tmp_path):
    from maskrcnn_tf2_tpu_torch.cli import coco_train

    root = str(tmp_path / "coco")
    shapes_coco_datasets(root, (4, 2), size=64, seed=4, class_names=["background"] + coco_train.MINITRAIN_CLASSES)
    argv = ["-dataset_path", root, "-backbone", "resnet18", "-img_size", "64", "-batch_size", "2", "-epochs", "1",
            "--minitrain", "--no_augment", "--sync_bn", "--checkpoints_dir", str(tmp_path / "logs"),
            "--device", "cpu"]
    out = multihost_dryrun.launch(workers.cli_run, 2, (argv, TINY_WIDTHS), timeout_s=TIMEOUT)
    assert out[0]["step"] == out[1]["step"] == 2
    assert all(out[0]["sync"]) and len(out[0]["sync"]) > 20
    assert all(np.array_equal(out[0]["state"][k], v) for k, v in out[1]["state"].items())
    assert all(np.isfinite(v).all() for v in out[0]["state"].values())
