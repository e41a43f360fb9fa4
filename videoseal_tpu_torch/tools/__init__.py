"""Offline tools: weight conversion and checkpoint evaluation."""
