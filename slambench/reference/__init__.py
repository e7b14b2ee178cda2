"""The plain reference and the comparison that decides ``correct``
(``check``). Imports nothing of the program under test."""
