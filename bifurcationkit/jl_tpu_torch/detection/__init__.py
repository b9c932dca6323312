from .bifurcation import (detect_bifurcation, get_bifurcation_type,
                          locate_bifurcation, locate_fold)
from .events import (ContinuousEvent, DiscreteEvent, PairOfEvents,
                     SetOfEvents, bif_detect_event, fold_detect_event,
                     save_at_event)
from .points import (BifPoint, BranchPoint, Fold, Hopf, NdBranchPoint,
                     Pitchfork, SpecialPoint, Transcritical)
