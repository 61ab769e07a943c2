"""Study tools of the port (the robustness sweep)."""
