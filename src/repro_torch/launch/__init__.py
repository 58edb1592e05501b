"""The serve step and the serving loop of the LM/MoE stack."""
