"""The port's counterpart of scripts/parity_sweep.py: see
dynamic_visual_slam_tpu_torch/evaluation/parity_sweep.py for the arguments.

    python scripts/torch_parity_sweep.py --help
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dynamic_visual_slam_tpu_torch.evaluation import parity_sweep  # noqa: E402

if __name__ == "__main__":
    sys.exit(parity_sweep.main())
