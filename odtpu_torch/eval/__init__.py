"""VOC mAP and the evaluator that runs the eval step over a loader."""
