"""Compile and cache every device program class the bench workloads
use, with no deadlines, so later CLI runs and bench stages in the same
cache directory start warm (see km_tpu/utils/jaxcache.py for where the
cache lives).

Usage: python scripts/warm_cache.py [--quick]
  --quick skips the 4000-target size classes.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from km_tpu.utils import jaxcache  # noqa: E402

jaxcache.enable()


def _log(msg):
    print("[warm %s] %s" % (time.strftime("%H:%M:%S"), msg), flush=True)


def main():
    quick = "--quick" in sys.argv
    import bench as B

    _log("counting kernel (2^24 chunk)")
    B.stage_counting(iters=4)
    _log("device pipeline, 400-target classes")
    B.stage_devwalk()
    _log("e2e stream counting kernel")
    B.stage_e2e()
    if not quick:
        _log("device pipeline, 4000-target classes")
        B.stage_scale()
    _log("done — cache at %s" % jaxcache.cache_dir())


if __name__ == "__main__":
    main()
