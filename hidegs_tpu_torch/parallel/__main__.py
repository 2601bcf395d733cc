"""python -m hidegs_tpu_torch.parallel --nproc N [--backend nccl|gloo] [--device cuda|cpu]"""
import sys

from hidegs_tpu_torch.parallel.dryrun import main

if __name__ == "__main__":
    sys.exit(main())
