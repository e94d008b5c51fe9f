"""Model families and the arch registry."""
