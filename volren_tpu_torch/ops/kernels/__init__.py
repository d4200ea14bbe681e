"""The render kernel and the tables it reads."""
