"""``python -m qfedx_tpu_torch train|serve ...`` (see ``run/cli.py``)."""

from qfedx_tpu_torch.run.cli import main

if __name__ == "__main__":
    main()
