"""The port's command-line scripts, one module a script of the JAX
repository's scripts/: scripts/loadgen.py (`loadgen`), scripts/obs_report.py
(`obs_report`), scripts/ops_console.py (`ops_console`) and
scripts/fault_drill.py (`fault_drill`). Run each as
`python -m bigdl_tpu_torch.scripts.<name>`.
"""
