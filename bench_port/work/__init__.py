"""Work counts from shapes alone, and the card's published peaks."""
