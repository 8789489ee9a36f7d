"""Balloon toy dataset (counterpart of ``maskrcnn_tf2_tpu/data/balloon.py``):
a single-class VIA dataset, ``{"background": 0, "balloon": 1}``. Any
VIA-annotated dataset loads the same way through ``VIADataset.load_via``
with its own class dict."""

from __future__ import annotations

import os

from maskrcnn_tf2_tpu_torch.config import DEFAULT_CLASS_DICT
from maskrcnn_tf2_tpu_torch.data.dataset import VIADataset


class BalloonDataset(VIADataset):
    def load_balloon(self, dataset_dir: str, subset: str = "train", annotations_json: str = "via_region_data.json"):
        self.load_via(os.path.join(dataset_dir, subset), annotations_json, DEFAULT_CLASS_DICT, source="balloon")
