"""Whether the flagship's bf16 engine computes eager's numbers build after
build on a CUDA card, and how far one changed rounding moves the served
detections at seeded random weights.

    python -m maskrcnn_tf2_tpu_torch.trace_engine_numerics [--builds 3] [--kinds autotuned,deterministic] [--out DIR]

Serves the 4 requests of 2 images that ``chip_smoke.py`` serves (seeded
smooth images, its sizes) through the flagship predictor (ResNet-50-FPN,
512x512, 81 classes, bf16, seeded random weights,
``detection_min_confidence=0``) with cuDNN's defaults: the reference. Then,
beside the card's name and power limit, each variant against the reference:
the share of detection rows equal bit for bit, of class ids equal over all
slots (``chip_smoke.py``'s per-slot measure), whether the masks are equal,
and the largest score difference. The variants:

- eager again in this process: as the reference, with ``cudnn.benchmark``
  (algorithms chosen by timing), with ``cudnn.deterministic``, and one image
  a forward (the rows of a data-parallel replica);
- eager in a fresh process;
- ``--builds`` engines at batch 2 of each of ``--kinds``: with Inductor's
  ``deterministic`` option off ("autotuned") or on ("deterministic"), the
  rest of ``build_engine``'s options as they are; each built and served in
  a fresh process with an empty Inductor cache, and compared bit for bit
  with its kind's first build too. For each pair of builds of a kind: the
  autotuned Triton kernels (the cache's ``.best_config`` files) that only
  one of them generated, and of those both generated, how many chose
  another configuration.

Everything each process served is written under ``--out``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from maskrcnn_tf2_tpu_torch.config import MaskRCNNConfig
from maskrcnn_tf2_tpu_torch.export import engine as engine_mod
from maskrcnn_tf2_tpu_torch.export.inference import process_input
from maskrcnn_tf2_tpu_torch.models.mask_rcnn import MaskRCNN
from maskrcnn_tf2_tpu_torch.predictor import Predictor
from maskrcnn_tf2_tpu_torch.train.synthetic import smooth_image
from maskrcnn_tf2_tpu_torch.weights import lecun_init_

SEED = 0
REQUEST_SIZES = [((480, 640), (427, 640)), ((640, 480), (375, 500)),
                 ((600, 800), (333, 500)), ((720, 1280), (384, 512))]


def flagship():
    cfg = MaskRCNNConfig(image_shape=(512, 512, 3), num_classes=81, backbone="resnet50",
                         compute_dtype="bfloat16", detection_min_confidence=0.0)
    sd = lecun_init_(MaskRCNN(cfg, device="cpu"), torch.Generator().manual_seed(SEED)).state_dict()
    rs = np.random.RandomState(SEED)
    batches = []
    for sizes in REQUEST_SIZES:
        molded, metas = zip(*(process_input(smooth_image(rs, *hw), cfg, i) for i, hw in enumerate(sizes)))
        batches.append((np.stack(molded), np.stack(metas)))
    return cfg, sd, batches


def host(outs):
    return [tuple(t.float().cpu().numpy() for t in out) for out in outs]


def serve_eager(predictor, batches, one_image=False):
    with torch.no_grad():
        if not one_image:
            return host(predictor._forward(m, me) for m, me in batches)
        outs = []
        for m, me in batches:
            rows = [predictor._forward(m[i:i + 1], me[i:i + 1]) for i in range(len(m))]
            outs.append(tuple(torch.cat([r[k] for r in rows]) for k in range(2)))
        return host(outs)


def worker(kind: str, out: str) -> None:
    """In a fresh process (with an empty ``TORCHINDUCTOR_CACHE_DIR``): serve
    the requests eagerly (``kind`` "eager") or through an engine built with
    Inductor's ``deterministic`` option off or on ("autotuned",
    "deterministic"); write the outputs and the autotuned configurations."""
    device = torch.device("cuda")
    cfg, sd, batches = flagship()
    if kind == "eager":
        outs = serve_eager(Predictor(cfg, sd, device=device), batches)
    else:
        shipped = engine_mod._eager_numerics
        engine_mod._eager_numerics = lambda: {**shipped(), "deterministic": kind == "deterministic"}
        path = engine_mod.build_engine(cfg, sd, out + ".engine", batch_size=2, device=device)
        engine = engine_mod.load_engine(path, device)
        outs = host(engine.run(m, me) for m, me in batches)
        os.remove(path)
    np.savez(out + ".npz", **{f"{k}{i}": o[j] for i, o in enumerate(outs) for j, k in enumerate(("det", "masks"))})
    cache = os.environ["TORCHINDUCTOR_CACHE_DIR"]
    configs = {}
    for p in glob.glob(os.path.join(cache, "**", "*.best_config"), recursive=True):
        with open(p) as f:
            configs[os.path.relpath(p, cache)] = json.load(f)
    with open(out + ".json", "w") as f:
        json.dump(configs, f)


def fresh_process(kind: str, out: str):
    with tempfile.TemporaryDirectory() as cache:
        env = dict(os.environ, TORCHINDUCTOR_CACHE_DIR=cache)
        proc = subprocess.run([sys.executable, "-m", __spec__.name, "--worker", kind, out], env=env,
                              capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"the {kind} process failed:\n{proc.stderr[-4000:]}")
    data = np.load(out + ".npz")
    outs = [(data[f"det{i}"], data[f"masks{i}"]) for i in range(len(data.files) // 2)]
    with open(out + ".json") as f:
        return outs, json.load(f)


def compare(outs, ref):
    det = np.stack([o[0] for o in outs])
    ref_det = np.stack([r[0] for r in ref])
    return dict(rows_equal=float((det == ref_det).all(-1).mean()),
                slot_classes=float((det[..., 4] == ref_det[..., 4]).mean()),
                masks_equal=all(np.array_equal(o[1], r[1]) for o, r in zip(outs, ref)),
                max_score_diff=float(np.abs(det[..., 5] - ref_det[..., 5]).max()))


TIMING_KEYS = ("time_taken_ms", "triton_cache_hash")  # a .best_config's record of its run, not its choice


def config_changes(configs):
    """For each pair of builds: the autotuned kernels only one of them
    generated, and of those both generated, how many chose another
    configuration (and how many of those are reductions)."""
    choice = [{k: {f: v for f, v in c.items() if f not in TIMING_KEYS} for k, c in conf.items()} for conf in configs]
    out = []
    for i in range(len(choice)):
        for j in range(i + 1, len(choice)):
            both = sorted(set(choice[i]) & set(choice[j]))
            diff = [k for k in both if choice[i][k] != choice[j][k]]
            reductions = [k for k in diff if any(key.startswith(("R0_", "R_", "RBLOCK")) for key in choice[i][k])]
            out.append(dict(pair=(i, j), autotuned=(len(choice[i]), len(choice[j])),
                            only_in_one=len(set(choice[i]) ^ set(choice[j])), in_both=len(both),
                            other_choice=len(diff), other_choice_reductions=len(reductions)))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--builds", type=int, default=3, help="engines of each kind")
    ap.add_argument("--kinds", default="autotuned,deterministic", help="comma-separated: autotuned, deterministic")
    ap.add_argument("--out", default="chiprun_out/trace_engine_numerics")
    ap.add_argument("--worker", nargs=2, metavar=("KIND", "OUT"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("trace_engine_numerics needs a CUDA card")
    if args.worker:
        return worker(*args.worker)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    os.makedirs(args.out, exist_ok=True)
    cfg, sd, batches = flagship()
    predictor = Predictor(cfg, sd, device="cuda")
    ref = serve_eager(predictor, batches)
    results = {"eager again": compare(serve_eager(predictor, batches), ref)}
    for flag in ("benchmark", "deterministic"):
        setattr(torch.backends.cudnn, flag, True)
        results[f"eager, cudnn.{flag}"] = compare(serve_eager(predictor, batches), ref)
        setattr(torch.backends.cudnn, flag, False)
    results["eager, one image a forward"] = compare(serve_eager(predictor, batches, one_image=True), ref)
    del predictor
    torch.cuda.empty_cache()
    results["eager, fresh process"] = compare(fresh_process("eager", os.path.join(args.out, "eager"))[0], ref)
    changes = {}
    for kind in args.kinds.split(","):
        configs, first = [], None
        for b in range(args.builds):
            outs, conf = fresh_process(kind, os.path.join(args.out, f"{kind}{b}"))
            first = first or outs
            results[f"engine, {kind}, build {b}"] = {
                **compare(outs, ref), "same_bits_as_build_0": all(
                    np.array_equal(x, y) for o, f in zip(outs, first) for x, y in zip(o, f))}
            configs.append(conf)
        changes[kind] = config_changes(configs)
    for name, r in results.items():
        print(f"{name}: {json.dumps(r)}")
    for kind, c in changes.items():
        print(f"autotuned configurations between {kind} builds: {json.dumps(c)}")
    print(card)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump({"card": card, "results": results, "config_changes": changes}, f, indent=1)


if __name__ == "__main__":
    main()
