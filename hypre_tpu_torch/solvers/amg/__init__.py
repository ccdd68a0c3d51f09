from .boomeramg import AMGLevel, BoomerAMG, BoomerAMGOptions
from .ams import AMS, AMSOptions
from .amgdd import AMGDD, AMGDDDevice, AMGDDOptions
from .block_amg import BlockAMG, BlockAMGOptions, BlockELL, block_spmv, bsr_to_block_ell

# PILUT (.pilut), MGR (.mgr), ADS (.ads), AME (.ame) and smoothed
# aggregation (.smoothed_aggregation) are imported by their module paths

__all__ = ["AMGDD", "AMGDDDevice", "AMGDDOptions", "AMGLevel", "AMS",
           "AMSOptions", "BlockAMG", "BlockAMGOptions", "BlockELL",
           "BoomerAMG", "BoomerAMGOptions", "block_spmv", "bsr_to_block_ell"]
