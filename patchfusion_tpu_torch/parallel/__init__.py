"""Scale-out over torch.distributed (patchfusion_tpu/parallel/): process
groups, the tile split and data parallelism (dist.py), and the metric
gather (gather.py)."""
