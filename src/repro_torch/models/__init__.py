"""Dense decoder-only model: dims, layers, attention, LM, facade."""
