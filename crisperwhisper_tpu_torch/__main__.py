"""`python -m crisperwhisper_tpu_torch` == the port's CLI transcriber
(crisperwhisper_tpu_torch.cli; on the CUDA card unless --device cpu)."""

import sys

from .cli import main

sys.exit(main())
