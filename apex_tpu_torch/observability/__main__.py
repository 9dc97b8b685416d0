import sys

from apex_tpu_torch.observability.cli import main

if __name__ == "__main__":
    sys.exit(main())
