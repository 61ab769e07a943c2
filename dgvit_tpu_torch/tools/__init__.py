"""Study tools of the port (the robustness sweep, the teacher's demos)."""
