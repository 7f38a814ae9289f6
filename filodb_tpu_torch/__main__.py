"""``python -m filodb_tpu_torch`` -> the CLI."""

from .cli import main

if __name__ == "__main__":
    main()
