"""VOC annotations, the batch loader and the on-device photometric augmentation."""
