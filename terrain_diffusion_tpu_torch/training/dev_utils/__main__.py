"""Dev visualization CLI: ``python -m
terrain_diffusion_tpu_torch.training.dev_utils <tool>`` (also mounted as
``python -m terrain_diffusion_tpu_torch dev-viz``)."""
import click

from terrain_diffusion_tpu_torch.training.dev_utils.curves import main as noise_loss_curve
from terrain_diffusion_tpu_torch.training.dev_utils.dataset_viz import main as dataset
from terrain_diffusion_tpu_torch.training.dev_utils.figs import (pipeline_viz, signed_sqrt,
                                                                 windows)
from terrain_diffusion_tpu_torch.training.dev_utils.model_viz import (autoencoder,
                                                                      base_diffusion,
                                                                      consistency_decoder)
from terrain_diffusion_tpu_torch.training.dev_utils.noise_viz import main as noise


@click.group(help="Dataset/model/pipeline visualizers (headless-first; "
                  "interactive browsing with a display)")
def cli():
    pass


for cmd in (dataset, autoencoder, base_diffusion, consistency_decoder,
            noise_loss_curve, noise, pipeline_viz, windows, signed_sqrt):
    cli.add_command(cmd)


if __name__ == "__main__":
    cli()
