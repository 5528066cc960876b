"""``python -m hplflownet_tpu_torch.native``: see ``check.py``."""

from .check import main

if __name__ == "__main__":
    main()
