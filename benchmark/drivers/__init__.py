"""Driver kinds: ``drivers/<kind>.py`` runs a cell of that kind once."""
