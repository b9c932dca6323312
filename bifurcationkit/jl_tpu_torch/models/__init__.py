from .sh import swift_hohenberg_2d
