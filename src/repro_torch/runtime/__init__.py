"""Elastic membership and failure detection for the LM trainer."""
