"""define-splits (counterpart of
``terrain_diffusion_tpu.data.preprocessing.define_splits``): a reproducible
train / val split by chunk id, kept in a CSV and written onto every
dataset's ``split`` attr.  Host only; HDF5 needs ``h5py``.
"""
from __future__ import annotations

import csv
import os

import click
import numpy as np


def split_dataset(h5_file: str, val_pct: float = 0.1, seed: int = 0,
                  splits_csv: str | None = None, resolution: int | None = None):
    import h5py

    with h5py.File(h5_file, "a") as f:
        res_keys = [str(resolution)] if resolution else list(f.keys())
        chunk_ids = sorted({cid for rk in res_keys for cid in f[rk]})
        assignments: dict[str, str] = {}
        if splits_csv and os.path.exists(splits_csv):
            with open(splits_csv) as fh:
                for row in csv.reader(fh):
                    if len(row) == 2:
                        assignments[row[0]] = row[1]
            print(f"loaded {len(assignments)} split assignments from {splits_csv}")
        rng = np.random.default_rng(seed)
        for cid in chunk_ids:
            if cid not in assignments:
                assignments[cid] = "val" if rng.random() < val_pct else "train"
        if splits_csv:
            with open(splits_csv, "w", newline="") as fh:
                w = csv.writer(fh)
                for cid in sorted(assignments):
                    w.writerow([cid, assignments[cid]])
        n = {"train": 0, "val": 0}
        for rk in res_keys:
            for cid in f[rk]:
                split = assignments.get(cid, "train")
                for sub in f[rk][cid]:
                    for dset in f[rk][cid][sub].values():
                        dset.attrs["split"] = split
                n[split] += 1
        print(f"assigned: {n}")


@click.command("define-splits")
@click.argument("h5_file", type=click.Path(exists=True))
@click.option("--val-pct", type=float, default=0.1)
@click.option("--seed", type=int, default=0)
@click.option("--splits-csv", default="data/splits.csv")
@click.option("--resolution", type=int, default=None)
def main(h5_file, val_pct, seed, splits_csv, resolution):
    """Define reproducible train/val splits by chunk id."""
    split_dataset(h5_file, val_pct, seed, splits_csv, resolution)


if __name__ == "__main__":
    main()
