"""The weight tools: ``ckpt_to_npz`` (a port checkpoint to ``odtpu``'s
npz) and ``convert_torch_weights`` (a reference ``.pth`` to the npz that
both packages load); the model reports: ``get_flops`` (conv MACs by the
reference's formula, and the whole forward's FLOPs), ``get_rf`` (the
receptive fields of VGG16-SSD300) and ``get_featuremap_size`` (the
source maps and their priors)."""
