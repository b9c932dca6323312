from .algorithms import PALC, Natural
from .driver import continuation
from .engine import ContIterable, ContState
from .results import ContResult
from .tangents import Bordered, Secant
