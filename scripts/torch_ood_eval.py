"""The port's counterpart of scripts/ood_eval.py: see
dynamic_visual_slam_tpu_torch/evaluation/ood.py for the arguments.

    python scripts/torch_ood_eval.py --help
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dynamic_visual_slam_tpu_torch.evaluation import ood  # noqa: E402

if __name__ == "__main__":
    sys.exit(ood.main())
