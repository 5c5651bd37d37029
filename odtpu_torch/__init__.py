"""odtpu_torch — the PyTorch/CUDA port of odtpu for one NVIDIA H100.

A package beside ``odtpu`` (the JAX reference, which it never imports).
Module names follow ``odtpu`` so each counterpart is easy to find:

- ``utils.config``, ``utils.yml``: the defaults with any yml laid over
  them (``load_cfg`` of a name of ``CFGS`` or of a path), read without
  PyYAML.
- ``ops``: box math, priors, exact top-k, greedy NMS and the detect path
  (RefineDet's two-step decode too).
- ``ops.cuda``: the hand-written CUDA greedy-NMS kernel (source in
  ``csrc/``), built with ``nvcc`` at first use and bound with ``ctypes``.
- ``models``: the zoo: SSD, FPN, FSSD, RFBNet, DRN_SSD and RefineDet over
  VGG16 (with or without batch norm) or the DRN-D bases.
- ``eval_step`` / ``infer``: uint8 images in, ``[B, R, 6]`` rows out
  (or the dense ``[B, C, K, 5]`` under ``EVAL.COMPACT = False``).
- ``data``: image decoding (PPM without OpenCV), the host augmentation
  with its C++ sampler (``csrc/sampler.cc``, built with g++), VOC, COCO,
  the loader and ``dataset_factory``.
- ``train_step`` / ``train``: training of every family, and
  ``python -m odtpu_torch.train``.
- ``eval``: VOC and COCO mAP, and ``python -m odtpu_torch.eval``.
- ``trace``: the spans at the layers' boundaries, off unless enabled,
  and ``record_function`` labels under a profiler.

Public boundaries keep ``odtpu``'s NHWC layout; convs run NCHW inside.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
