"""A pool worker for ``tests/test_torch_genetics.py``'s checks of
``veles_tpu_torch.subproc.run_workers``: reads a JSON spec on stdin;
``{"fail": text}`` writes text to stderr and exits 1, ``{"sleep": s}``
sleeps s seconds; then prints ``{"pid": ..., "spec": ...}`` as its
last stdout line."""

import json
import os
import sys
import time


def main():
    spec = json.load(sys.stdin)
    if "fail" in spec:
        sys.stderr.write(spec["fail"] + "\n")
        return 1
    time.sleep(spec.get("sleep", 0))
    print("log line before the result")
    print(json.dumps({"pid": os.getpid(), "spec": spec}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
