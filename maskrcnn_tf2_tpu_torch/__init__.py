"""PyTorch/CUDA port of the Mask R-CNN framework in ``maskrcnn_tf2_tpu``.

Serves the inference forward and runs the single-device training step on an
NVIDIA Hopper card, with hand-written CUDA kernels (``csrc/``) for greedy NMS
and pyramid ROIAlign, forward and backward. The package imports PyTorch,
numpy and the standard library only; it never imports JAX or the JAX
package. Entry points (``predictor.Predictor``, ``models.mask_rcnn.MaskRCNN``,
``train.train_step``) run on the card unless ``device="cpu"`` is passed.
"""
