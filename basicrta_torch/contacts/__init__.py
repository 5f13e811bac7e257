"""Contact data model (event tables) of the port."""

from basicrta_torch.contacts.records import ContactEvents, ContactMeta

__all__ = ["ContactEvents", "ContactMeta"]
