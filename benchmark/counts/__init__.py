"""The frozen operation and byte counts and the cards' published peaks."""
