from .equilibria import (brusselator_1d, carrier, cgl2d, chan,
                         chan_spectral, hopf_normal_2d, lorenz84,
                         pitchfork_1d, stuart_landau, transcritical_1d)
from .sh import mittelmann, swift_hohenberg_2d
