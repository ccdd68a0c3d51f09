from .split import SStructSplit, SplitOptions
from .fac import FAC, FACOptions, build_composite_poisson
from .maxwell import SStructMaxwell, SStructMaxwellOptions
