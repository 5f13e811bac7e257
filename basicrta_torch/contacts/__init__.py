"""Contact-map extraction and residence-event construction."""

from basicrta_torch.contacts.records import (ContactEvents, ContactMeta,
                                             ContactRecords, FrameBatch)
from basicrta_torch.contacts.events import merge_events
from basicrta_torch.contacts.distances import min_dist_per_residue_pair
from basicrta_torch.contacts.mapper import MapContacts, ProcessContacts

__all__ = [
    "ContactRecords",
    "ContactEvents",
    "ContactMeta",
    "FrameBatch",
    "merge_events",
    "min_dist_per_residue_pair",
    "MapContacts",
    "ProcessContacts",
]
