"""`python -m numpywren_tpu_torch.native.build` — compile the native schedule core."""

import sys

from numpywren_tpu_torch.native import _SO, build

if __name__ == "__main__":
    ok = build(force="--force" in sys.argv)
    print(f"{'built' if ok else 'FAILED to build'} {_SO}")
    sys.exit(0 if ok else 1)
