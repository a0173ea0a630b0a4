"""``python -m zkp2p_tpu_torch <command>``: the port's command line."""

from .pipeline.cli import main

if __name__ == "__main__":
    main()
