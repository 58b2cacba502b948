"""Command line of the PyTorch port (counterpart of
``terrain_diffusion_tpu.__main__``):

    python -m terrain_diffusion_tpu_torch <command> [arguments]

Commands import lazily, so ``--help`` stays fast.  Every command that runs
work on a device (a model, or the dataset builders' Laplacian encode) runs
it on the card unless it is given ``--device cpu`` (``onnx-export`` its
verifying forward, ``export`` its trace and check, ``dev-viz`` its model,
pipeline, threefry-field and terrain-composite tools); ``define-splits``,
``build-synthetic-stats`` and ``dev-viz windows`` / ``signed-sqrt`` run on
the host.  ``api`` and
``mc-api`` are argparse programs: the group hands them the rest of the
command line unchanged (``api --help`` is theirs).
"""
import importlib

import click


class LazyGroup(click.Group):
    """Click group resolving subcommands from module paths on demand."""

    def __init__(self, *args, lazy_subcommands=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.lazy_subcommands = lazy_subcommands or {}

    def list_commands(self, ctx):
        return sorted(set(super().list_commands(ctx)) | set(self.lazy_subcommands))

    def get_command(self, ctx, cmd_name):
        if cmd_name in self.lazy_subcommands:
            mod_path, attr = self.lazy_subcommands[cmd_name].rsplit(":", 1)
            return getattr(importlib.import_module(mod_path), attr)
        return super().get_command(ctx, cmd_name)


cli = LazyGroup(
    help="Terrain Diffusion (PyTorch port) - main entry point for all commands",
    lazy_subcommands={
        # training
        "train": "terrain_diffusion_tpu_torch.training.train:main",
        "save-model": "terrain_diffusion_tpu_torch.training.save_model:main",
        # data preprocessing
        "build-base-dataset":
            "terrain_diffusion_tpu_torch.data.preprocessing.build_base_dataset:main",
        "build-encoded-dataset":
            "terrain_diffusion_tpu_torch.data.preprocessing.build_encoded_dataset:main",
        "define-splits": "terrain_diffusion_tpu_torch.data.preprocessing.define_splits:main",
        "build-synthetic-stats": "terrain_diffusion_tpu_torch.pipeline.synthetic_map:build_stats_main",
        # inference / serving
        "explore": "terrain_diffusion_tpu_torch.serving.explorer.server:main",
        "generate": "terrain_diffusion_tpu_torch.serving.world_generator:main",
        "azgaar-to-tiff": "terrain_diffusion_tpu_torch.serving.azgaar_to_tiff:main",
        "tiff-export": "terrain_diffusion_tpu_torch.serving.tiff_export:main",
        # benchmarks
        "latency": "terrain_diffusion_tpu_torch.evaluation.latency:main",
        # export
        "onnx-export": "terrain_diffusion_tpu_torch.export.onnx_export:main",
        "export": "terrain_diffusion_tpu_torch.export.torch_export:main",
        # dev visualization harness
        "dev-viz": "terrain_diffusion_tpu_torch.training.dev_utils.__main__:cli",
    },
)


def _forward(name: str, module: str, summary: str):
    """A command that calls ``module.main(argv)`` with the rest of the line."""

    @cli.command(name, help=summary, add_help_option=False,
                 context_settings={"ignore_unknown_options": True, "allow_extra_args": True})
    @click.pass_context
    def command(ctx):
        return importlib.import_module(module).main(list(ctx.args))

    return command


_forward("api", "terrain_diffusion_tpu_torch.serving.api", "Terrain API server.")
_forward("mc-api", "terrain_diffusion_tpu_torch.serving.minecraft_api",
         "Minecraft terrain API server.")


if __name__ == "__main__":
    cli()
