"""Prints a cProfile stats file sorted by cumulative time (counterpart of
``dm_control_tpu/scripts/print_profile.py``; reference:
dm_control/scripts/print_profile.py:1-4):

    python -m dm_control_torch.scripts.print_profile profile.out
"""

import pstats
import sys


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    stats = pstats.Stats(argv[0] if argv else "profile")
    stats.sort_stats("cumulative").print_stats(50)
    return stats


if __name__ == "__main__":
    main()
