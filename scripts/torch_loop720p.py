"""The port's counterpart of scripts/loop720p.py: see
dynamic_visual_slam_tpu_torch/evaluation/loop720p.py for the arguments.

    python scripts/torch_loop720p.py --help
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dynamic_visual_slam_tpu_torch.evaluation import loop720p  # noqa: E402

if __name__ == "__main__":
    sys.exit(loop720p.main())
