"""Training of the proxy nets (counterpart of pg2024_dprt_tpu/train/):
datasets by ray casting (datagen), their preparation (datasets), the loop
and npz checkpoints (loop), evaluation (eval) and the command line
(`python -m pg2024_dprt_tpu_torch.train`)."""
from .datagen import generate_proxy_dataset
from .datasets import balance_vis, depth_only, split_train_test, shuffle
from .loop import TrainConfig, fit, train_proxy_for_partition
