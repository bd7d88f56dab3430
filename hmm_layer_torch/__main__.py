"""``python -m hmm_layer_torch <command>`` (see :mod:`hmm_layer_torch.cli`)."""

import sys

from .cli import main

sys.exit(main())
