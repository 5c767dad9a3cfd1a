"""The plain reference of the consensus round (step, escalation merge,
route), frozen beside the benchmark.  Imports nothing of the system
under test."""
