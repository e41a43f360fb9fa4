"""The plain float32 reference of the cards' serving paths. It imports no part of the port."""
