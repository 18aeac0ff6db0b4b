"""The port's examples: one module for each file of the JAX
repository's `examples/`, each runnable as
`python -m bigdl_tpu_torch.examples.<name> [--device cuda|cpu]` (on the
CUDA card by default; `--device cpu` runs the plain PyTorch path on the
host). Each keeps its JAX counterpart's model, synthetic data, seeds,
schedule and printed lines, and writes only to temporary directories or
to the paths its flags give. `distributed_data_parallel` and
`moe_expert_parallel` run under `torchrun` at any world size, or in one
process; `pipeline_parallel_lm` needs 4 ranks (`torchrun
--nproc_per_node 4`). No single JAX counterpart: the JAX repository's
examples/ is a folder of scripts, not a package."""
