"""``python -m moleculediffusiontransformer_tpu_torch`` (see ``cli.py``)."""
from .cli import main

if __name__ == "__main__":
    main()
