from .boomeramg import AMGLevel, BoomerAMG, BoomerAMGOptions

__all__ = ["AMGLevel", "BoomerAMG", "BoomerAMGOptions"]
