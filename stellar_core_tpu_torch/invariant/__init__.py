"""Invariant framework (reference: src/invariant/)."""

from .invariants import (ALL_INVARIANTS, AccountSubEntriesCountIsValid,
                         BucketListIsConsistentWithDatabase,
                         ConservationOfLumens, ConstantProductInvariant,
                         Invariant, InvariantDoesNotHold, InvariantManager,
                         LedgerCloseContext, LedgerEntryIsValid,
                         LiabilitiesMatchOffers, SponsorshipCountIsValid)

__all__ = [
    "ALL_INVARIANTS", "AccountSubEntriesCountIsValid",
    "BucketListIsConsistentWithDatabase", "ConservationOfLumens",
    "ConstantProductInvariant", "Invariant", "InvariantDoesNotHold",
    "InvariantManager", "LedgerCloseContext", "LedgerEntryIsValid",
    "LiabilitiesMatchOffers", "SponsorshipCountIsValid",
]
