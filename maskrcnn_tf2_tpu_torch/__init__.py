"""PyTorch/CUDA port of the Mask R-CNN framework in ``maskrcnn_tf2_tpu``.

Serves the inference forward on an NVIDIA Hopper card, with hand-written
CUDA kernels (``csrc/``) for greedy NMS and pyramid ROIAlign. The package
imports PyTorch, numpy and the standard library only; it never imports JAX
or the JAX package. Entry points (``predictor.Predictor``,
``models.mask_rcnn.MaskRCNN``) run on the card unless ``device="cpu"`` is
passed.
"""
