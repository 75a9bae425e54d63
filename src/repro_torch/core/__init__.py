"""Fabric IR, assembler, benches and the cycle-accurate engine."""
