"""``python -m odtpu_torch.eval``: see :mod:`odtpu_torch.eval.cli`."""

from .cli import main

if __name__ == "__main__":
    main()
