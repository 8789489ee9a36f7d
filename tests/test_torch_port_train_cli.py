"""The port's training CLI (``cli/coco_train.py``) and TensorBoard writer
(``utils/tb_writer.py``) against the JAX package's, on the CPU.

* For the same argv over a synthetic COCO directory, both CLIs hand their
  ``train_model`` (replaced here by a recorder, in both modules) a
  configuration with the same md5, datasets with the same image ids, and an
  augmentation in the same cases; a built augmentation gives the JAX
  package's pixels for the same seeds (bit for bit, as
  ``tests/test_torch_port_host_augment.py`` holds them).
* One real run on the CPU, with the widths made tiny through the CLI's
  ``coco_config``: 1 epoch of 2 steps with host augmentation (both optional
  sets), a best-only checkpoint under the configuration's md5, and the
  losses in TensorBoard.
* ``--sync_bn`` without a process group exits with the model's error (under
  ``torchrun`` it trains: ``tests/test_torch_port_multihost.py``); without
  ``--device`` the CLI asks for the card.
"""

import random

import numpy as np
import pytest
import torch

from maskrcnn_tf2_tpu.cli import coco_train as jax_cli

from maskrcnn_tf2_tpu_torch.cli import coco_train as port_cli
from maskrcnn_tf2_tpu_torch.config import coco_config
from maskrcnn_tf2_tpu_torch.train import checkpoint as ckpt_lib
from maskrcnn_tf2_tpu_torch.train.synthetic import shapes_coco_datasets
from maskrcnn_tf2_tpu_torch.utils import tb_writer

from test_torch_port_serving import TINY_WIDTHS


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs six test processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def coco_dir(tmp_path_factory):
    """A synthetic COCO set (5 train and 3 val images, 64 px) whose
    categories carry the --minitrain names."""
    root = str(tmp_path_factory.mktemp("coco"))
    shapes_coco_datasets(root, (5, 3), size=64, seed=4, class_names=["background"] + port_cli.MINITRAIN_CLASSES)
    return root


def recorded(module, monkeypatch):
    calls = []
    monkeypatch.setattr(module, "train_model", lambda cfg, train, val, augment_fn=None, **kw: calls.append(
        (cfg, train, val, augment_fn)))
    return calls


def run_both(argv, monkeypatch):
    jax_calls, port_calls = recorded(jax_cli, monkeypatch), recorded(port_cli, monkeypatch)
    jax_cli.main(list(argv))
    port_cli.main(list(argv) + ["--device", "cpu"])
    return jax_calls[0], port_calls[0]


CASES = {
    "defaults": [],
    "small": ["-backbone", "resnet18", "-img_size", "64", "-batch_size", "2", "-epochs", "3", "-lr", "0.01",
              "-optimizer", "sgd"],
    "minitrain": ["--minitrain", "--n_train", "3", "--n_val", "2", "--no_mini_masks", "--year", "2017"],
    "device_augment": ["--device_augment", "--sample_cache", "cache"],
    "no_augment": ["--no_augment", "--checkpoints_dir", "elsewhere"],
    "both_sets": ["--augment_weather", "--augment_extended"],
    "weights": ["--weights", "imagenet", "--backbone", "resnet34"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_builds_the_jax_configuration_and_datasets(case, coco_dir, monkeypatch):
    argv = ["-dataset_path", coco_dir] + CASES[case]
    (jcfg, jtrain, jval, jaug), (pcfg, ptrain, pval, paug) = run_both(argv, monkeypatch)
    assert pcfg.md5() == jcfg.md5()
    assert pcfg.to_dict() == jcfg.to_dict()
    for port_ds, jax_ds in ((ptrain, jtrain), (pval, jval)):
        assert len(port_ds) == len(jax_ds) > 0
        assert [i["id"] for i in port_ds.image_info] == [i["id"] for i in jax_ds.image_info]
        assert port_ds.class_names == jax_ds.class_names
    assert (paug is None) == (jaug is None) == (case in ("device_augment", "no_augment"))
    if paug is not None:
        rs = np.random.RandomState(0)
        image, masks = rs.randint(0, 256, (64, 64, 3)).astype(np.uint8), rs.rand(64, 64, 2) > 0.7
        for seed in range(8):
            random.seed(seed)
            np.random.seed(seed)
            want = jaug(image, masks)
            got = paug(image, masks, random.Random(seed), np.random.RandomState(seed))
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("typed", [[], ["-epochs", "7", "--minitrain"]])
def test_cli_config_file_overridden_only_by_typed_flags(typed, coco_dir, tmp_path, monkeypatch):
    """A YAML whose values differ from every CLI default: untyped flags leave
    them, typed ones win, in both packages alike."""
    path = str(tmp_path / "cfg.yaml")
    coco_config(backbone="resnet18", epochs=2, batch_size=4, learning_rate=0.02, image_shape=(128, 128, 3),
                image_min_dim=128, image_max_dim=128, num_classes=9, use_mini_masks=False).to_yaml(path)
    (jcfg, *_), (pcfg, *_) = run_both(["-dataset_path", coco_dir, "--config", path] + typed, monkeypatch)
    assert pcfg.md5() == jcfg.md5()
    assert pcfg.backbone == "resnet18" and pcfg.batch_size == 4 and pcfg.image_shape == (128, 128, 3)
    assert (pcfg.epochs, pcfg.num_classes) == ((7, 5) if typed else (2, 9))


def test_cli_refuses_sync_bn(coco_dir, capsys, monkeypatch):
    """Outside ``torchrun`` there is no process group to take the batch
    statistics over: the CLI exits with the model's own message."""
    from maskrcnn_tf2_tpu_torch.models.mask_rcnn import check_sync_bn

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError) as model_error:
        check_sync_bn(coco_config(sync_bn=True), None)
    with pytest.raises(SystemExit):
        port_cli.main(["-dataset_path", coco_dir, "--sync_bn", "--device", "cpu"])
    assert str(model_error.value) in capsys.readouterr().err


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal on a machine without a card")
def test_cli_asks_for_the_card_by_default(coco_dir):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli.main(["-dataset_path", coco_dir])


def test_cli_trains_on_the_cpu_with_host_augmentation(coco_dir, tmp_path, monkeypatch, capsys):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    monkeypatch.setattr(port_cli, "coco_config", lambda **kw: coco_config(**{**TINY_WIDTHS, "log_per_steps": 1, **kw}))
    ckpt, tb = str(tmp_path / "logs"), str(tmp_path / "tb")
    state = port_cli.main(["-dataset_path", coco_dir, "-backbone", "resnet18", "-img_size", "64", "-batch_size", "2",
                           "-epochs", "1", "--n_train", "4", "--minitrain", "--augment_weather", "--augment_extended",
                           "--checkpoints_dir", ckpt, "--tensorboard", tb, "--device", "cpu"])
    assert "train: 4 images, val: 3 images, 5 classes, backbone=resnet18" in capsys.readouterr().out
    assert state.step == 2
    cfg = port_cli.coco_config(backbone="resnet18", epochs=1, batch_size=2, num_classes=5, image_shape=(64, 64, 3),
                               image_min_dim=64, image_max_dim=64, checkpoints_dir=ckpt)
    assert ckpt_lib.make_manager(cfg).all_steps() == [0]  # saved under its epoch index
    events = EventAccumulator(tb)
    events.Reload()
    assert "loss_sum" in events.Tags()["scalars"]
    assert [e.step for e in events.Scalars("loss_sum")] == [1, 2]
    assert all(np.isfinite(e.value) for e in events.Scalars("loss_sum"))


def test_tb_writer_round_trip(tmp_path, monkeypatch):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    write = tb_writer.make_tb_writer(str(tmp_path))
    write(3, {"loss": 1.5, "lr": 0.001})
    write(4, {"loss": 1.25, "lr": 0.001})
    events = EventAccumulator(str(tmp_path))
    events.Reload()
    assert [(e.step, e.value) for e in events.Scalars("loss")] == [(3, 1.5), (4, 1.25)]
    assert [e.value for e in events.Scalars("lr")] == pytest.approx([0.001, 0.001])
    monkeypatch.setitem(__import__("sys").modules, "torch.utils.tensorboard", None)
    assert tb_writer.make_tb_writer(str(tmp_path / "none")) is None
