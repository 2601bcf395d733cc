"""Multi-GPU training: the view-parallel step (sharded.py; captured as a
CUDA graph by compiled.py) over a
("data", "model") mesh (mesh.py) of torch.distributed ranks
(distributed.py), camera bands (bands.py) and the dry runs (dryrun.py,
`python -m hidegs_tpu_torch.parallel`)."""
