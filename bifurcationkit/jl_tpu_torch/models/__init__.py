from .equilibria import (brusselator_1d, carrier, chan, hopf_normal_2d,
                         lorenz84, pitchfork_1d, transcritical_1d)
from .sh import mittelmann, swift_hohenberg_2d
