"""Tiny configurations and mixes of the benchmark's cells, for runs on the CPU."""

from benchmark import harness


def serve_cfg(dtype: str = "float32") -> dict:
    cfg = harness.load_json("configs", "r50_fpn_512")
    cfg.update(image_shape=[128, 128, 3], image_min_dim=128, image_max_dim=128, pre_nms_limit=256,
               post_nms_rois_inference=64, detection_max_instances=10, fpn_cls_fc_layers_size=128,
               mask_conv_channels=64, top_down_pyramid_size=64, compute_dtype=dtype,
               rpn_anchor_scales=[8, 16, 32, 64, 128], detection_min_confidence=0.0)
    return cfg


SERVE_LIMITS = {"ingress_max_abs": 0.0, "rpn_rel": 1e-3, "proposal_mismatch": 0.0, "class_logp_rel": 1e-3,
                "box_delta_rel": 1e-3, "detection_mismatch": 0.0, "mask_logit_rel": 1e-3, "unmold_mismatch": 0.0}
STREAM = {"loop": "offline_stream", "size": [96, 128], "batch_size": 2, "depth": 2, "pool": 6, "sample_from": 2,
          "sample_batches": 1}
