"""The weight tools: ``ckpt_to_npz`` (a port checkpoint to ``odtpu``'s
npz) and ``convert_torch_weights`` (a reference ``.pth`` to the npz that
both packages load)."""
