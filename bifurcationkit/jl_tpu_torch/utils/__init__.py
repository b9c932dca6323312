from .io import load_branch, resume_data, save_branch, save_every_step
from .plotting import (plot_bifurcation_diagram, plot_branch,
                       plot_periodic_orbit, savefig)
