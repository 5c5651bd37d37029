"""Receptive fields of the VGG16-SSD300 conv stack: ``python -m
odtpu_torch.tools.get_rf``.

Counterpart of root ``get_rf.py`` (the reference's get_rf.py): per layer
the receptive field, jump (stride in input pixels) and output size by the
recurrence ``rf' = rf + (k_eff - 1) * jump``, ``jump' = jump * stride``.
"""

from __future__ import annotations

# (name, kernel, stride, padding, dilation[, ceil mode]) of the
# vgg16-ssd300 trunk
VGG16_SSD300_LAYERS = [
    ("conv1_1", 3, 1, 1, 1), ("conv1_2", 3, 1, 1, 1), ("pool1", 2, 2, 0, 1),
    ("conv2_1", 3, 1, 1, 1), ("conv2_2", 3, 1, 1, 1), ("pool2", 2, 2, 0, 1),
    ("conv3_1", 3, 1, 1, 1), ("conv3_2", 3, 1, 1, 1), ("conv3_3", 3, 1, 1, 1),
    ("pool3(ceil)", 2, 2, 0, 1, True),
    ("conv4_1", 3, 1, 1, 1), ("conv4_2", 3, 1, 1, 1), ("conv4_3", 3, 1, 1, 1),
    ("pool4", 2, 2, 0, 1),
    ("conv5_1", 3, 1, 1, 1), ("conv5_2", 3, 1, 1, 1), ("conv5_3", 3, 1, 1, 1),
    ("pool5", 3, 1, 1, 1),
    ("conv6(d6)", 3, 1, 6, 6), ("conv7", 1, 1, 0, 1),
    ("extras0", 1, 1, 0, 1), ("extras1", 3, 2, 1, 1),
    ("extras2", 1, 1, 0, 1), ("extras3", 3, 2, 1, 1),
    ("extras4", 1, 1, 0, 1), ("extras5", 3, 1, 0, 1),
    ("extras6", 1, 1, 0, 1), ("extras7", 3, 1, 0, 1),
]


def receptive_fields(layers=VGG16_SSD300_LAYERS, image_size=300):
    """-> [(name, rf, jump, size)] with the classic recurrence."""
    rf, jump, size = 1, 1, image_size
    rows = []
    for layer in layers:
        name, k, s, p, d = layer[:5]
        ceil = len(layer) > 5 and layer[5]
        eff_k = d * (k - 1) + 1
        rf = rf + (eff_k - 1) * jump
        num = size + 2 * p - eff_k
        size = (-(-num // s) if ceil else num // s) + 1
        jump = jump * s
        rows.append((name, rf, jump, size))
    return rows


def main():
    print("{:<14} {:>6} {:>6} {:>6}".format("layer", "rf", "jump", "size"))
    for name, rf, jump, size in receptive_fields():
        print("{:<14} {:>6} {:>6} {:>6}".format(name, rf, jump, size))


if __name__ == "__main__":
    main()
