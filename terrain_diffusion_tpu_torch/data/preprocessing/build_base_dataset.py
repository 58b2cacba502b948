"""build-base-dataset (counterpart of
``terrain_diffusion_tpu.data.preprocessing.build_base_dataset``): drives the
per-cell preprocessing over the equal-area grid from a thread pool and
writes ``{res}/{chunk}/{subchunk}/{residual,lowfreq,lowres_exact,climate}``
to HDF5 (lzf), with ocean-tile subsampling, an idempotent skip of existing
chunks and Welford stats in the resolution group's attrs.

The threads share one device and its default stream; each cell's Laplacian
encode runs there (``elevation.process_single_cell``).  Results are taken in
the grid's order (``Executor.map``), so the ocean-subsampling draws follow
the same order as JAX's.  HDF5 needs ``h5py``.
"""
from __future__ import annotations

import concurrent.futures as cf

import click
import numpy as np
from tqdm import tqdm

from terrain_diffusion_tpu_torch.common.cli_helpers import click_check_device
from terrain_diffusion_tpu_torch.data.preprocessing.elevation import process_single_cell
from terrain_diffusion_tpu_torch.data.welford import Welford
from terrain_diffusion_tpu_torch.data.world_grid import create_equal_area_grid


def build_base_dataset(
    output_file: str,
    highres_elevation_folder: str,
    lowres_elevation_file: str,
    climate_folder: str | None,
    resolution: int = 90,
    highres_size: int = 4096,
    lowres_size: int = 512,
    lowres_sigma: float = 5.0,
    num_chunks: int = 4,
    edge_margin: int = 0,
    cell_size_m: float = 368640.0,
    ocean_keep_pct: float = 0.2,
    num_workers: int = 8,
    data_source: str = "merit",
    seed: int = 0,
    *,
    device="cuda",
):
    import h5py

    cells = create_equal_area_grid((cell_size_m, cell_size_m))
    rng = np.random.default_rng(seed)
    stats = Welford(1)
    lf_stats = Welford(1)

    with h5py.File(output_file, "a") as f:
        res_group = f.require_group(str(resolution))
        todo = [(str(i), b) for i, b in enumerate(cells) if str(i) not in res_group]
        todo_skipped = len(todo) < len(cells)
        print(f"{len(todo)} cells to process ({len(cells)} total)")

        def work(item):
            chunk_id, bounds = item
            try:
                return process_single_cell(
                    chunk_id, bounds, highres_elevation_folder,
                    lowres_elevation_file, highres_size, lowres_size,
                    lowres_sigma, num_chunks=num_chunks,
                    climate_folder=climate_folder, edge_margin=edge_margin,
                    data_source=data_source, device=device)
            except Exception as e:  # noqa: BLE001 - one failed cell does not end the build
                print(f"cell {chunk_id} failed: {e!r}")
                return []

        with cf.ThreadPoolExecutor(num_workers) as ex:
            for chunks in tqdm(ex.map(work, todo), total=len(todo)):
                for c in chunks:
                    if c["pct_land"] == 0 and rng.random() > ocean_keep_pct:
                        continue
                    g = res_group.require_group(c["chunk_id"]).require_group(c["subchunk_id"])
                    keys = ("residual", "lowfreq", "lowres_exact") + (
                        ("climate",) if c.get("climate") is not None else ())
                    for key in keys:
                        d = g.create_dataset(key, data=c[key].astype(np.float32),
                                             compression="lzf")
                        d.attrs["pct_land"] = c["pct_land"]
                        d.attrs["split"] = "train"
                    stats.update(c["residual"][None])
                    lf_stats.update(c["lowfreq"][None])
        # a resumed run's Welford accumulators saw only the new chunks: never
        # overwrite the dataset-wide stats with them (a no-op rerun would write std 0)
        if not stats.count.any():
            print("no new chunks: keeping the existing stats attrs")
        elif "residual_mean" in res_group.attrs and todo_skipped:
            print(f"resume: {stats.count} new samples NOT folded into the "
                  "stored stats attrs (they cover the full prior build); "
                  "delete the attrs to force a recompute from a full rerun")
        else:
            res_group.attrs["residual_mean"] = stats.mean[0]
            res_group.attrs["residual_std"] = stats.std[0]
            res_group.attrs["lowfreq_mean"] = lf_stats.mean[0]
            res_group.attrs["lowfreq_std"] = lf_stats.std[0]
    if stats.count.any():
        print(f"residual stats: mean={stats.mean[0]:.4f} std={stats.std[0]:.4f}")
        print(f"lowfreq stats: mean={lf_stats.mean[0]:.4f} std={lf_stats.std[0]:.4f}")


@click.command("build-base-dataset")
@click.argument("output_file", type=click.Path())
@click.option("--highres-folder", required=True)
@click.option("--lowres-file", required=True)
@click.option("--climate-folder", default=None)
@click.option("--resolution", type=int, default=90)
@click.option("--highres-size", type=int, default=4096)
@click.option("--lowres-size", type=int, default=512)
@click.option("--lowres-sigma", type=float, default=5.0)
@click.option("--num-chunks", type=int, default=4)
@click.option("--edge-margin", type=int, default=0)
@click.option("--ocean-keep-pct", type=float, default=0.2)
@click.option("--num-workers", type=int, default=8)
@click.option("--data-source", type=click.Choice(["merit", "copernicus"]),
              default="merit")
@click.option("--device", default="cuda", show_default=True,
              help="--device cpu runs on the CPU")
def main(output_file, highres_folder, lowres_file, climate_folder, resolution,
         highres_size, lowres_size, lowres_sigma, num_chunks, edge_margin,
         ocean_keep_pct, num_workers, data_source, device):
    """Build the base terrain dataset from downloaded DEM cells."""
    click_check_device(device)
    build_base_dataset(output_file, highres_folder, lowres_file, climate_folder,
                       resolution, highres_size, lowres_size, lowres_sigma,
                       num_chunks, edge_margin, ocean_keep_pct=ocean_keep_pct,
                       num_workers=num_workers, data_source=data_source, device=device)


if __name__ == "__main__":
    main()
