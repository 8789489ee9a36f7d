"""PyTorch/CUDA port of the Mask R-CNN framework in ``maskrcnn_tf2_tpu``.

Serves the inference forward, trains from random or pretrained ResNet
weights and evaluates COCO AP on an NVIDIA Hopper card, with hand-written
CUDA kernels (``csrc/``) for greedy NMS and pyramid ROIAlign, forward and
backward. The package imports PyTorch, numpy and the standard library only;
it never imports JAX or the JAX package. Entry points
(``predictor.Predictor``, ``models.mask_rcnn.MaskRCNN``, ``train.train_step``,
``train.loop.train_model``, the ``cli`` modules) run on the card unless the
CPU is asked for.
"""
