"""Multi-GPU: data-parallel training (`mesh.py`: process groups, DDP
meshes of ranks), one image partitioned in row bands over devices
(`spatial.py`) and a multi-rank dry run (`dryrun.py`)."""
