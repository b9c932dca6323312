from .equilibria import (bogdanov_takens_2d, brusselator_1d, bvam_1d,
                         carrier, cgl2d, chan, chan_spectral, co_oxidation,
                         fold_hopf_interaction_2d, freire, hopf_normal_2d,
                         lorenz84, lure, neumann_laplacian_dia,
                         neumann_laplacian_dia_1d, pitchfork_1d,
                         stuart_landau, swift_hohenberg_1d, transcritical_1d,
                         tsodyks_markram)
from .sh import (mittelmann, swift_hohenberg_2d, swift_hohenberg_3d,
                 swift_hohenberg_periodic_2d)
