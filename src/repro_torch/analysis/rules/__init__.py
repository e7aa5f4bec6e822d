"""The port's zenlint rule set.  Each module encodes one invariant of
the paged serving data plane; ``ALL_RULES`` is the registry the engine
and the CLI instantiate.  ZL001 and ZL005 are copies of the reference's
rules (they read the pool's API names, which both packages share); ZL002,
ZL003 and ZL004 are the PyTorch counterparts of its jit rules.
"""

from repro_torch.analysis.rules.accounting import AccountingPairing
from repro_torch.analysis.rules.donation import DonationAfterUse
from repro_torch.analysis.rules.hostsync import HostSyncInHotPath
from repro_torch.analysis.rules.provenance import PageIdProvenance
from repro_torch.analysis.rules.recompile import RecompileHazard

ALL_RULES = [PageIdProvenance, DonationAfterUse, RecompileHazard,
             HostSyncInHotPath, AccountingPairing]

__all__ = ["ALL_RULES", "PageIdProvenance", "DonationAfterUse",
           "RecompileHazard", "HostSyncInHotPath", "AccountingPairing"]
