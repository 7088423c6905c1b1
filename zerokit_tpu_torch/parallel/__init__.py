"""Multi-device proving over torch.distributed: a ("dp", "tp") mesh of ranks.

Counterpart of zerokit_tpu/parallel/. sharded.py holds the mesh, its
collectives and the tensor-parallel MSM; ntt_sharded.py the Bailey NTT
over the tp axis; launch.py starts the ranks; dryrun.py drives the tiers.
"""
