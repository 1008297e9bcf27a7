"""The planner's pieces ported so far: the hardware profile sweep."""
