from .algorithms import (PALC, AutoSwitch, MoorePenrose, MoorePenroseLS,
                         Multiple, Natural)
from .driver import continuation
from .engine import ContIterable, ContState
from .results import Branch, ContResult, merge_branches
from .tangents import Bordered, Polynomial, Secant
from .deflated import DCResult, DefCont, deflated_continuation
