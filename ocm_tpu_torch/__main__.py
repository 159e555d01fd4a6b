"""``python -m ocm_tpu_torch`` entry point (see ocm_tpu_torch/cli.py)."""

import sys

from ocm_tpu_torch.cli import main

sys.exit(main())
