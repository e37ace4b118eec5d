"""The yardstick's arithmetic: the operations and bytes a kernel or a step
needs, counted from shapes, and the card's published peaks."""
