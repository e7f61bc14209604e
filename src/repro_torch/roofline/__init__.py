"""Roofline model of the card: the hardware profiles the tile autotuner
scores candidates against."""
