"""VOC and COCO mAP, the evaluators that run the eval step over a loader,
and the ``python -m odtpu_torch.eval`` command line (``cli``)."""
