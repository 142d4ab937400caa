"""Plain fp32 references, independent of the program under test."""
