"""Combine channels, message plans, the BSP loop and the cost model."""
