"""Optional Spark adapter.

Ports bigdl_tpu/dataset/spark_adapter.py. The reference's entire L0
substrate is Spark — RDDs carry the data, BlockManager carries the
gradients (SURVEY.md §1). Here, as in the JAX package, Spark is out of
the core; this adapter is the bridge for users whose data already
lives in Spark: pull an RDD/DataFrame of (feature, label) into the
port's `DataSet`, sharded per process.

pyspark is NOT a dependency — everything is duck-typed against the RDD
surface (`collect`) so plain lists of rows and test fakes work
identically. Where the JAX module reads `jax.process_index()` /
`process_count()`, this one reads the `torch.distributed` rank and
world size when a group is initialised, and 0/1 otherwise.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from bigdl_tpu_torch.dataset.dataset import DataSet, LocalDataSet
from bigdl_tpu_torch.dataset.sample import Sample

__all__ = ["rdd_to_dataset", "dataframe_to_dataset"]


def _to_sample(row: Any) -> Sample:
    if isinstance(row, Sample):
        return row
    if isinstance(row, dict):
        return Sample(np.asarray(row["features"]),
                      np.asarray(row["label"]))
    feature, label = row
    return Sample(np.asarray(feature), np.asarray(label))


def _process_group() -> tuple:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def rdd_to_dataset(rdd: Any, process_id: Optional[int] = None,
                   num_processes: Optional[int] = None) -> LocalDataSet:
    """Materialize an RDD of (feature, label) rows / dicts / Samples into
    a LocalDataSet. In a multi-process job, pass this process's rank and
    the world size (defaulted from the torch.distributed group when one
    is initialised) and each process keeps only its shard — mirroring the
    reference's partition-per-executor layout without Spark executors
    doing the training."""
    rows = rdd.collect() if hasattr(rdd, "collect") else list(rdd)
    if (process_id is None) != (num_processes is None):
        raise ValueError(
            "pass process_id and num_processes together (or neither, to "
            "read them from the torch.distributed process group)")
    if process_id is None:
        process_id, num_processes = _process_group()
    if num_processes > 1:
        rows = rows[process_id::num_processes]
    return DataSet.array([_to_sample(r) for r in rows])


def dataframe_to_dataset(df: Any, features_col: str = "features",
                         label_col: str = "label", **kw) -> LocalDataSet:
    """Spark DataFrame → DataSet via its RDD of Rows (duck-typed: any
    object with `.select(...).rdd` or dict-like rows)."""
    if hasattr(df, "select"):
        rdd = df.select(features_col, label_col).rdd
        return rdd_to_dataset(rdd, **kw)
    # plain dict-of-columns (the estimator API's DataFrame stand-in)
    rows = list(zip(df[features_col], df[label_col]))
    return rdd_to_dataset(rows, **kw)
