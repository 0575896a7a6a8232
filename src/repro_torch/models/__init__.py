"""The dense LM family."""
