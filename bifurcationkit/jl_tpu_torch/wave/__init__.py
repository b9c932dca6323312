from .freezing import EigenWave, travelling_wave_problem
