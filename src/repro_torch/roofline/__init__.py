"""Roofline analysis from the dry run's artifacts (counterpart of the JAX
package's ``roofline``), read against an H100 by default."""

from .analysis import (H100, HW, V5E, CellRoofline, analyze_all, analyze_cell,
                       format_report)

__all__ = ["HW", "H100", "V5E", "CellRoofline", "analyze_cell", "analyze_all",
           "format_report"]
