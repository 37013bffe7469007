"""``python -m scythe_tpu_torch [options] model_file.py``: the CLI
(``scythe_tpu_torch.cli``, the port of run_scythe.py)."""

from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
